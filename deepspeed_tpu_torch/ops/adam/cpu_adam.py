"""Host Adam and Adagrad for the optimizer offload (counterpart of
``deepspeed_tpu/ops/adam/cpu_adam.py``).

``DeepSpeedCPUAdam`` and ``DeepSpeedCPUAdagrad`` update fp32 CPU tensors
in place through the AVX2/FMA OpenMP library ``csrc/cpu_adam.cpp``
(built by ``ops/op_builder.load_host``), one native call a tensor: the
tensors are passed by ``data_ptr()``. The offload keeps them pinned where
they feed a copy to or from the card. These are host ops, not kernels of
the card: nothing here counts launches.
"""

import ctypes
import itertools

import torch

from deepspeed_tpu_torch.ops import op_builder

_ids = itertools.count()


def _ptr(t):
    """A float pointer to an fp32 contiguous CPU tensor."""
    if t.dtype != torch.float32 or t.device.type != "cpu" or \
            not t.is_contiguous():
        raise ValueError(f"CPU-Adam takes contiguous fp32 CPU tensors, got "
                         f"{t.dtype} on {t.device}")
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_float))


def _host_fp32(t):
    """``t`` as a contiguous fp32 CPU tensor: itself when it is one."""
    t = t.detach()
    if t.dtype == torch.float32 and t.device.type == "cpu" and \
            t.is_contiguous():
        return t
    return t.to(device="cpu", dtype=torch.float32).contiguous()


class DeepSpeedCPUAdam:
    """Adam/AdamW over host tensors (the reference wrapper's surface):
    built over ``params`` (fp32 CPU tensors, updated in place), each
    ``step(grads)`` one fused native update a tensor; the moments
    ``exp_avg`` / ``exp_avg_sq`` live beside them. The bias correction is
    always applied (the kernel folds it into the step size), as in JAX's
    wrapper, which takes ``bias_correction`` and ignores it."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, bias_correction=True,
                 fp32_optimizer_states=True):
        self.lib = op_builder.load_host("cpu_adam")
        self.opt_id = next(_ids)
        self.lr = lr
        self.bias_correction = bias_correction
        self.lib.ds_adam_create(self.opt_id, betas[0], betas[1], eps,
                                weight_decay, 1 if adamw_mode else 0)
        self.params = [_host_fp32(p) for p in params]
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.step_count = 0

    def step(self, grads, lr=None):
        """One step over every tensor; ``grads`` match ``params``."""
        self.step_count += 1
        for i, g in enumerate(grads):
            self.step_single(i, g, lr=lr, step_no=self.step_count)
        return self.params

    def step_single(self, idx, grad, lr=None, step_no=None):
        """One tensor's update: the unit the NVMe swapper's pipeline
        interleaves with its reads and writes."""
        lr = self.lr if lr is None else lr
        step_no = self.step_count if step_no is None else step_no
        p, m, v = self.params[idx], self.exp_avg[idx], self.exp_avg_sq[idx]
        g = _host_fp32(grad)
        if g.numel() != p.numel():
            raise ValueError(f"gradient {idx} has {g.numel()} elements, its "
                             f"parameter {p.numel()}")
        rc = self.lib.ds_adam_step(self.opt_id, step_no, lr, _ptr(p),
                                   _ptr(g), _ptr(m), _ptr(v), p.numel())
        if rc != 0:
            raise RuntimeError(f"ds_adam_step failed ({rc})")

    def __del__(self):
        try:
            self.lib.ds_adam_destroy(self.opt_id)
        except Exception:
            pass


class DeepSpeedCPUAdagrad:
    """Adagrad over host tensors through ``ds_adagrad_step`` (the
    reference's ``ops/adagrad/cpu_adagrad.py``)."""

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0):
        self.lib = op_builder.load_host("cpu_adam")
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.params = [_host_fp32(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def step(self, grads, lr=None):
        lr = self.lr if lr is None else lr
        for p, g, v in zip(self.params, grads, self.exp_avg_sq):
            g = _host_fp32(g)
            rc = self.lib.ds_adagrad_step(lr, self.eps, self.weight_decay,
                                          _ptr(p), _ptr(g), _ptr(v),
                                          p.numel())
            if rc != 0:
                raise RuntimeError(f"ds_adagrad_step failed ({rc})")
        return self.params
