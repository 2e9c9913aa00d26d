"""Loss-scale state machine (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The state is three host numbers. The JAX package keeps them on the device
and updates them inside the compiled step with ``lax.cond``; here the
engine reads the one overflow flag an fp16 step needs and updates the
state on the host, which is the port's only per-step host sync.
"""

from typing import NamedTuple


class LossScaleState(NamedTuple):
    loss_scale: float
    good_steps: int      # consecutive overflow-free steps
    hysteresis: int      # remaining tolerated overflows


def make_scale_state(init_scale, delayed_shift=1):
    return LossScaleState(loss_scale=float(init_scale), good_steps=0,
                          hysteresis=int(delayed_shift))


def update_scale(state: LossScaleState, overflow, *, dynamic=True,
                 scale_factor=2.0, scale_window=1000, min_scale=1.0,
                 delayed_shift=1) -> LossScaleState:
    """The scale update rule (reference DynamicLossScaler.update_scale).

    On overflow: consume hysteresis; once exhausted, divide the scale by
    ``scale_factor`` (not below ``min_scale``) and restore the hysteresis.
    After ``scale_window`` consecutive good steps: multiply the scale and
    restore the hysteresis."""
    if not dynamic:
        return state
    if overflow:
        hyst = state.hysteresis - 1
        if hyst <= 0:
            return LossScaleState(
                loss_scale=max(state.loss_scale / scale_factor, min_scale),
                good_steps=0, hysteresis=int(delayed_shift))
        return LossScaleState(loss_scale=state.loss_scale, good_steps=0,
                              hysteresis=hyst)
    good = state.good_steps + 1
    if good % scale_window == 0:
        return LossScaleState(loss_scale=state.loss_scale * scale_factor,
                              good_steps=good, hysteresis=int(delayed_shift))
    return state._replace(good_steps=good)
