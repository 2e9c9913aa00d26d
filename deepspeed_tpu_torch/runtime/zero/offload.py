"""ZeRO-Offload: the Adam moments in host RAM or on NVMe, the update on
the CPU (counterpart of ``deepspeed_tpu/runtime/zero/offload.py``).

The reference's offload paths (``stage_1_and_2.py`` cpu_offload,
``async_accumulate_grad_in_cpu_via_gpu``; the NVMe optimizer swappers of
``runtime/swap_tensor/``). The card keeps the fp32 masters the forward
casts and their gradients; :class:`OffloadedOptimizer` keeps host fp32
masters of this rank's gradient layout (whole tensors at stages 0-1, the
rank's slices from stage 2: the reference's "rank owns its partition"
rule) and their Adam moments, 8 bytes a parameter, in RAM or, for
``device="nvme"``, in files written and read through the async IO engine
(``csrc/aio.cpp``). A step copies the gradients to pinned host buffers
(``non_blocking``, one synchronisation), runs the AVX CPU-Adam
(``csrc/cpu_adam.cpp``) tensor by tensor and copies the updated masters
back. On NVMe the moments of tensor i + 2 are read while tensor i is
updated and tensor i's are written back behind it (``_PREFETCH``, the
reference's pipelined optimizer swapper), and RAM holds only those in
flight. The swap folder (``nvme_path/ds_offload_<pid>_<n>``) is removed
when the optimizer is.

The host masters exist from construction, so a loaded state attaches at
once (the JAX class defers it to its first step, where it carves its
masters from the gradients' shards).
"""

import itertools
import os
import shutil
import time
import weakref

import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam


_folders = itertools.count()


def _host_buffer(like, pin):
    return torch.empty(tuple(like.shape), dtype=torch.float32,
                       pin_memory=pin)


class OffloadedOptimizer:
    """Host-resident Adam over ``params`` (``{name: tensor}``, this rank's
    pieces of the masters on the engine's device, in the engine's
    order)."""

    _PREFETCH = 2  # moment buffers in flight (double buffering)

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, nvme_path=None,
                 swap_folder=None):
        self.names = list(params)
        tensors = list(params.values())
        self.device = tensors[0].device if tensors else torch.device("cpu")
        self._pin = self.device.type == "cuda"
        masters = []
        for p in tensors:
            m = _host_buffer(p, self._pin)
            m.copy_(p.detach())
            masters.append(m)
        self.opt = DeepSpeedCPUAdam(masters, lr=lr, betas=betas, eps=eps,
                                    weight_decay=weight_decay,
                                    adamw_mode=adam_w_mode)
        # pinned gradient buffers the device copies land in (a CPU
        # engine's gradients are read where they are)
        self._grads = ([_host_buffer(p, True) for p in tensors]
                       if self._pin else None)
        self.last_host_ms = 0.0     # the last step's CPU-Adam (and swap) ms
        self.swapper = None
        if nvme_path is not None:
            from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
                AsyncTensorSwapper
            folder = swap_folder or os.path.join(
                nvme_path, f"ds_offload_{os.getpid()}_{next(_folders)}")
            self.swapper = AsyncTensorSwapper(folder)
            # the swap files are this object's alone: removed with it
            weakref.finalize(self, shutil.rmtree, folder, True)
            self._swap_out_states()

    # ---------------------------------------------------------------- nvme
    def _swap_out_states(self):
        """Write every moment to its file and drop it from RAM."""
        for i in range(len(self.names)):
            self.swapper.swap_out(f"m_{i}", self.opt.exp_avg[i])
            self.swapper.swap_out(f"v_{i}", self.opt.exp_avg_sq[i])
            self.opt.exp_avg[i] = self.opt.exp_avg_sq[i] = None
        self.swapper.synchronize()

    def _swap_in_states(self):
        for i in range(len(self.names)):
            self.opt.exp_avg[i] = self.swapper.swap_in(f"m_{i}")
            self.opt.exp_avg_sq[i] = self.swapper.swap_in(f"v_{i}")

    # ---------------------------------------------------------------- step
    def step(self, grads, lr):
        """One host Adam step over ``grads`` (``{name: tensor}`` on the
        engine's device, unscaled and clipped); returns the updated
        masters, ``{name: tensor}`` on the device (their copies are
        queued on the current stream)."""
        if self._pin:
            for buf, n in zip(self._grads, self.names):
                buf.copy_(grads[n].detach(), non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            host = self._grads
        else:
            host = [grads[n].detach() for n in self.names]
        self.opt.step_count += 1
        step_no = self.opt.step_count
        t0 = time.perf_counter()
        n = len(self.names)
        if self.swapper is None:
            for i in range(n):
                self.opt.step_single(i, host[i], lr=lr, step_no=step_no)
        else:
            # fetch i + _PREFETCH || adam(i) || write-back(i)
            fetches = {}

            def start(i):
                if i < n:
                    fetches[i] = (self.swapper.swap_in_async(f"m_{i}"),
                                  self.swapper.swap_in_async(f"v_{i}"))

            for i in range(min(self._PREFETCH, n)):
                start(i)
            for i in range(n):
                (m_buf, m_req), (v_buf, v_req) = fetches.pop(i)
                nbytes = m_buf.numel() * 4
                self.swapper.wait(m_req, nbytes)
                self.swapper.wait(v_req, nbytes)
                self.opt.exp_avg[i], self.opt.exp_avg_sq[i] = m_buf, v_buf
                start(i + self._PREFETCH)
                self.opt.step_single(i, host[i], lr=lr, step_no=step_no)
                self.swapper.swap_out(f"m_{i}", m_buf)
                self.swapper.swap_out(f"v_{i}", v_buf)
                self.opt.exp_avg[i] = self.opt.exp_avg_sq[i] = None
            self.swapper.synchronize()
        self.last_host_ms = (time.perf_counter() - t0) * 1e3
        if not self._pin:
            return dict(zip(self.names, self.opt.params))
        return {name: m.to(self.device, non_blocking=True)
                for name, m in zip(self.names, self.opt.params)}

    # ----------------------------------------------------------- state
    def state_dict(self):
        """``{"exp_avg": [...], "exp_avg_sq": [...], "step": n}``, one host
        tensor a master, in the engine's order (copies)."""
        if self.swapper is not None:
            self._swap_in_states()
        sd = {"exp_avg": [m.clone() for m in self.opt.exp_avg],
              "exp_avg_sq": [v.clone() for v in self.opt.exp_avg_sq],
              "step": self.opt.step_count}
        if self.swapper is not None:
            for i in range(len(self.names)):
                self.opt.exp_avg[i] = self.opt.exp_avg_sq[i] = None
        return sd

    def load_state_dict(self, sd):
        """Attach moments of :meth:`state_dict`'s form (each shaped like
        its master; arrays or tensors)."""
        for field in ("exp_avg", "exp_avg_sq"):
            if len(sd[field]) != len(self.names):
                raise ValueError(f"offload state holds {len(sd[field])} "
                                 f"{field} tensors, this optimizer "
                                 f"{len(self.names)}")
            setattr(self.opt, field, [
                torch.as_tensor(x, dtype=torch.float32).reshape(
                    p.shape).contiguous().clone()
                for x, p in zip(sd[field], self.opt.params)])
        self.opt.step_count = int(sd["step"])
        if self.swapper is not None:
            self._swap_out_states()
