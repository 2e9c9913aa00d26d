"""The user-facing MoE API (counterpart of ``deepspeed_tpu/moe/layer.py``).

``MoE`` keeps the JAX constructor surface (hidden_size, expert,
num_experts, ep_size, k, the capacity factors, noisy gating, RTS,
``use_residual`` for MoS, ``use_tutel``) and returns ``(output, l_aux,
exp_counts)`` as JAX's ``MoE.__call__`` does (:33-95); training mode is
the module's (``train()`` / ``eval()``), where JAX takes ``train=``.

The experts of a layer are stacked ``[E, ...]`` parameters, the layout
flax's ``nn.vmap`` gives them, kept in flax's ``[in, out]`` order (the
batched GEMMs read them as they are); at an expert-parallel size ``ep``
each rank holds E / ep of them. :func:`is_moe_param` picks the expert
parameters out by name, as the JAX one does by path.
"""

import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.moe.sharded_moe import MOELayer, lecun_normal_
from deepspeed_tpu_torch.ops.transformer.fused import moe_res_matmul
from deepspeed_tpu_torch.utils import groups

EXPERT_KEY = "deepspeed_experts"


class StackedDense(nn.Module):
    """``num_experts`` dense layers: ``weight`` [E, in, out], ``bias``
    [E, out] (a vmapped flax ``Dense``)."""

    def __init__(self, num_experts, in_features, out_features, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (num_experts, in_features, out_features), device=device,
            dtype=dtype))
        self.bias = nn.Parameter(torch.zeros((num_experts, out_features),
                                             device=device, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator=None, num_global=None, offset=0):
        """flax's Dense init (lecun-normal kernel, zero bias) for
        ``num_global`` experts, drawn in order; this module keeps experts
        ``offset ..`` of them."""
        E, fan_in, fan_out = self.weight.shape
        full = torch.empty((num_global or E, fan_in, fan_out),
                           device=self.weight.device)
        lecun_normal_(full, fan_in, generator)
        self.weight.copy_(full[offset:offset + E])
        self.bias.zero_()


class MLPExpert(nn.Module):
    """The default expert, stacked (JAX ``MLPExpert``, vmapped): fc1 ->
    tanh-GeLU -> fc2 on [E, C, M]. Plain GEMMs, as JAX's expert uses
    ``nn.gelu`` and not the bias-GeLU kernel."""

    def __init__(self, num_experts, hidden_size, intermediate_size=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        inner = intermediate_size or 4 * hidden_size
        self.fc1 = StackedDense(num_experts, hidden_size, inner, device,
                                dtype)
        self.fc2 = StackedDense(num_experts, inner, hidden_size, device,
                                dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None, num_global=None, offset=0):
        self.fc1.reset_parameters(generator, num_global, offset)
        self.fc2.reset_parameters(generator, num_global, offset)

    def forward(self, x):
        h = torch.bmm(x, self.fc1.weight) + self.fc1.bias[:, None, :]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.fc2.weight) + self.fc2.bias[:, None, :]

    def grouped(self, x, sizes):
        """The experts on ``x`` [N, M], rows sorted by expert, expert e
        taking the next ``sizes[e]`` rows (host ints): one pair of GEMMs an
        expert with rows (``jax.lax.ragged_dot``'s product)."""
        outs, start = [], 0
        for e, n in enumerate(sizes):
            if n == 0:
                continue
            h = x[start:start + n] @ self.fc1.weight[e] + self.fc1.bias[e]
            h = F.gelu(h, approximate="tanh")
            outs.append(h @ self.fc2.weight[e] + self.fc2.bias[e])
            start += n
        if not outs:
            return x.new_zeros((0, self.fc2.weight.shape[-1]))
        return torch.cat(outs)


class _DenseMLP(nn.Module):
    """MoS's residual MLP: one unstacked ``MLPExpert`` (``nn.Linear``
    weights, [out, in])."""

    def __init__(self, hidden_size, device=None, dtype=torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, 4 * hidden_size, device=device,
                             dtype=dtype)
        self.fc2 = nn.Linear(4 * hidden_size, hidden_size, device=device,
                             dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _dense_init(linear, generator):
    lecun_normal_(linear.weight, linear.weight.shape[1], generator)
    nn.init.zeros_(linear.bias)


class MoE(nn.Module):
    """Mixture-of-experts layer (JAX ``moe/layer.py`` ``MoE``).

    ``expert``: a stacked-expert module class (see
    ``sharded_moe.MOELayer``), default :class:`MLPExpert`; ``ep_size``
    (default: the expert-parallel group's) must equal the group's.
    ``use_tutel`` maps to the scatter impl (JAX keeps this reference ctor
    knob; tutel's optimisation is index-routed dispatch).
    ``use_residual`` is MoS: ``out · coef[0] + mlp(x) · coef[1]`` with
    ``coef = softmax(coefficient(x))``, mixed by ``moe_res_matmul``.
    ``drop_tokens=False`` takes the capacity C = the global token count
    (JAX's static worst case): the dense impl's [S, E, C] tensors then
    grow as S²·E."""

    def __init__(self, hidden_size, expert=None, num_experts=1, ep_size=None,
                 k=1, capacity_factor=1.0, eval_capacity_factor=1.0,
                 min_capacity=4, use_residual=False, noisy_gate_policy=None,
                 drop_tokens=True, use_rts=True, use_tutel=False,
                 dispatch_impl="scatter", expert_kwargs=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kwargs = dict(expert_kwargs or {})
        if expert in (None, MLPExpert) and "hidden_size" not in kwargs:
            kwargs["hidden_size"] = hidden_size
        self.use_residual = bool(use_residual)
        self.deepspeed_moe = MOELayer(
            hidden_size, num_experts, k, capacity_factor,
            eval_capacity_factor, min_capacity, noisy_gate_policy,
            drop_tokens, use_rts,
            dispatch_impl="scatter" if use_tutel else dispatch_impl,
            expert=expert, expert_kwargs=kwargs, ep_size=ep_size,
            device=device, dtype=dtype)
        if self.use_residual:
            self.mlp = _DenseMLP(hidden_size, device, dtype)
            self.coefficient = nn.Linear(hidden_size, 2, device=device,
                                         dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.deepspeed_moe.reset_parameters(generator)
        if self.use_residual:
            _dense_init(self.mlp.fc1, generator)
            _dense_init(self.mlp.fc2, generator)
            _dense_init(self.coefficient, generator)

    def forward(self, hidden_states, used_token=None):
        out, l_aux, exp_counts = self.deepspeed_moe(hidden_states,
                                                    used_token)
        if self.use_residual:
            mlp_out = self.mlp(hidden_states)
            coef = torch.softmax(self.coefficient(hidden_states), dim=-1)
            out = moe_res_matmul(out, coef, mlp_out)
        return out, l_aux, exp_counts


def is_moe_param(name: str) -> bool:
    """An expert parameter (JAX ``is_moe_param``: by its path)."""
    return EXPERT_KEY in name.split(".")


def expert_slice(name, tensor, local_shape):
    """This rank's experts of ``tensor``, a whole layer's ``[E, ...]``
    expert leaf, for a parameter of ``local_shape`` ([E / ep, ...]); the
    tensor itself when it already has that shape (or is not an expert
    leaf)."""
    if not is_moe_param(name) or tuple(tensor.shape) == tuple(local_shape):
        return tensor
    ep = groups.get_expert_parallel_world_size()
    n = local_shape[0]
    if tensor.shape[0] != n * ep or tuple(tensor.shape[1:]) != \
            tuple(local_shape[1:]):
        raise ValueError(f"expert leaf {name} of shape "
                         f"{tuple(tensor.shape)} does not hold {ep} ranks' "
                         f"{tuple(local_shape)}")
    start = groups.get_expert_parallel_rank() * n
    return tensor[start:start + n]


def localize_state_dict(state_dict, module):
    """``state_dict`` with each whole-layer expert leaf cut to this rank's
    experts (:func:`expert_slice`), for ``module.load_state_dict``."""
    shapes = {n: tuple(t.shape) for n, t in module.state_dict().items()}
    return {n: (expert_slice(n, t, shapes[n]) if n in shapes else t)
            for n, t in state_dict.items()}
