"""Communication verbs (counterpart of ``deepspeed_tpu/comm/__init__.py``).

Only the ``all_to_all`` verb is ported (JAX ``comm/__init__.py:219-222``),
for the MoE exchange. The JAX package's MoE layer puts a sharding
constraint on the dispatched ``[E, C, M]`` tensor and XLA lowers the
resharding to an all-to-all; the port makes the exchange itself, as the
reference DeepSpeed's ``_AllToAll`` (``sharded_moe.py:84``) does: an
``autograd.Function`` over ``torch.distributed.all_to_all_single``, whose
backward is the inverse exchange (with equal splits, the same one). It
runs over whatever backend the process group has: NCCL on the card,
gloo on the CPU.
"""

import torch

from deepspeed_tpu_torch.utils import groups


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, _AllToAll.apply(ctx.group, grad)


def all_to_all(x, group):
    """Exchange equal chunks of ``x``'s dimension 0 among the ranks of
    ``group``: chunk j goes to the group's rank j, and chunk j of the
    result comes from it. Differentiable. Raises without a process group
    or without ``group`` (a group of one rank has nothing to exchange:
    use ``x`` itself)."""
    if not groups.dist_active() or group is None:
        raise RuntimeError(
            "all_to_all needs an initialised process group and the group "
            "to exchange over (utils.groups.initialize(ep_size=...))")
    n = torch.distributed.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dimension 0 ({x.shape[0]}) is not "
                         f"a multiple of the group's {n} ranks")
    return _AllToAll.apply(group, x)
