"""Learning-rate schedules (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``): ``LRRangeTest``, ``OneCycle``,
``WarmupLR`` and ``WarmupDecayLR`` with the reference's parameter names.

Each is a function of the applied-step count, ``lr_at(step)``, computed on
the host; the engine hands the result to the optimizer update. The
stateful ``step()`` / ``get_lr()`` / ``state_dict()`` /
``load_state_dict()`` surface follows the JAX classes; the
momentum cycle of ``OneCycle`` is not ported (the JAX engine never reads
it).
"""

import math

VALID_LR_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR"]


class _LRSchedule:
    """Stateful stepping over a pure per-step lr function."""

    def __init__(self, last_batch_iteration=-1):
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        raise NotImplementedError

    def get_lr(self):
        return [float(self.lr_at(max(0, self.last_batch_iteration)))]

    def step(self):
        self.last_batch_iteration += 1

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_LRSchedule):
    """lr(t) = min_lr · (1 + t / step_size · step_rate), t floored to
    step_size multiples when ``staircase``."""

    def __init__(self, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        super().__init__(last_batch_iteration)

    def lr_at(self, step):
        if self.staircase:
            interval = math.floor(step / self.step_size)
        else:
            interval = step / float(self.step_size)
        return self.min_lr * (1.0 + interval * self.step_rate)


class OneCycle(_LRSchedule):
    """Linear ramp min → max over ``cycle_first_step_size`` steps, back
    down over ``cycle_second_step_size``, then decay by ``decay_lr_rate``
    per post-cycle step (or per ``decay_step_size`` steps). The stair and
    momentum keys are accepted and unused, as in the JAX engine."""

    def __init__(self, cycle_min_lr=1e-3, cycle_max_lr=1e-2,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 cycle_momentum=True, cycle_min_mom=0.85, cycle_max_mom=0.99,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = int(cycle_first_step_size)
        self.second_size = int(cycle_second_step_size
                               if cycle_second_step_size is not None
                               else cycle_first_step_size)
        self.decay_step_size = int(decay_step_size)
        self.total_size = self.first_size + self.second_size
        super().__init__(last_batch_iteration)

    def _cycle_pct(self, step):
        if step <= self.first_size:
            pct = step / float(self.first_size)
        else:
            pct = 1.0 - (step - self.first_size) / float(self.second_size)
        return min(max(pct, 0.0), 1.0)

    def _decay_steps(self, step):
        post = max(step - self.total_size, 0.0)
        if self.decay_step_size > 0:
            return math.floor(post / self.decay_step_size)
        return post

    def lr_at(self, step):
        if step <= self.total_size:
            return self.cycle_min_lr + (
                self.cycle_max_lr - self.cycle_min_lr) * self._cycle_pct(step)
        if self.decay_lr_rate > 0:
            return self.cycle_min_lr / (
                1.0 + self._decay_steps(step) * self.decay_lr_rate)
        return self.cycle_min_lr


class WarmupLR(_LRSchedule):
    """Warmup min → max over ``warmup_num_steps`` (log or linear), then
    constant max."""

    def __init__(self, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1):
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        super().__init__(last_batch_iteration)

    def _gamma_at(self, step):
        if step >= self.warmup_num_steps:
            return 1.0
        if self.warmup_type == "log":
            return self.inverse_log_warm_up * math.log(step + 1.0)
        return step / self.warmup_num_steps

    def lr_at(self, step):
        return self.min_lr + (self.max_lr - self.min_lr) * self._gamma_at(step)


class WarmupDecayLR(WarmupLR):
    """Warmup, then linear decay to zero at ``total_num_steps``."""

    def __init__(self, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 warmup_type="log", last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _gamma_at(self, step):
        if step < self.warmup_num_steps:
            return super()._gamma_at(step)
        return max(0.0, (self.total_num_steps - step) / max(
            1.0, float(self.total_num_steps - self.warmup_num_steps)))


SCHEDULE_CLASSES = {
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
}


def get_lr_schedule(name, params):
    """A schedule from its config name and params."""
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"unknown lr schedule {name}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return SCHEDULE_CLASSES[name](**(params or {}))
