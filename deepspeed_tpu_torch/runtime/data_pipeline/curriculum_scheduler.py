"""Curriculum learning scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``;
reference ``deepspeed/runtime/data_pipeline/curriculum_scheduler.py``,
``CurriculumScheduler`` :8): the step -> difficulty schedules
``fixed_linear`` (:60), ``fixed_root`` (:36), ``fixed_discrete`` (:89)
and ``custom``. The engine truncates the batch's sequence axis to the
scheduled difficulty before each forward
(:func:`apply_seqlen_truncation`), as the JAX engine does.
"""

import math
import warnings

CURRICULUM_LEARNING_MIN_DIFFICULTY = "min_difficulty"
CURRICULUM_LEARNING_MAX_DIFFICULTY = "max_difficulty"
CURRICULUM_LEARNING_SCHEDULE_TYPE = "schedule_type"
CURRICULUM_LEARNING_SCHEDULE_CONFIG = "schedule_config"
FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    def __init__(self, config):
        self.state = {}
        assert CURRICULUM_LEARNING_MIN_DIFFICULTY in config
        assert CURRICULUM_LEARNING_MAX_DIFFICULTY in config
        assert CURRICULUM_LEARNING_SCHEDULE_TYPE in config
        self.state[CURRICULUM_LEARNING_MIN_DIFFICULTY] = \
            config[CURRICULUM_LEARNING_MIN_DIFFICULTY]
        self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY] = \
            config[CURRICULUM_LEARNING_MAX_DIFFICULTY]
        self.state[CURRICULUM_LEARNING_SCHEDULE_TYPE] = \
            config[CURRICULUM_LEARNING_SCHEDULE_TYPE]
        self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG] = \
            config.get(CURRICULUM_LEARNING_SCHEDULE_CONFIG, {})
        self.state["current_difficulty"] = \
            config[CURRICULUM_LEARNING_MIN_DIFFICULTY]
        self.first_step = True
        self.custom_get_difficulty = None

        sched = self.state[CURRICULUM_LEARNING_SCHEDULE_TYPE]
        cfg = self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        if sched in (FIXED_LINEAR, FIXED_ROOT):
            assert "total_curriculum_step" in cfg
            assert "difficulty_step" in cfg
            if cfg["difficulty_step"] % 8 != 0:
                warnings.warn(
                    "difficulty_step not a multiple of 8 leaves the "
                    "sequence off the tensor cores' tile (the reference "
                    "warns for fp16 tensor cores)")
            if sched == FIXED_ROOT:
                assert "root_degree" in cfg
        elif sched == FIXED_DISCRETE:
            assert "difficulty" in cfg and "max_step" in cfg
            assert len(cfg["max_step"]) > 0
            assert len(cfg["difficulty"]) == len(cfg["max_step"]) + 1
        elif sched == CUSTOM:
            pass
        else:
            raise RuntimeError(f"unsupported schedule type {sched}")

    def get_current_difficulty(self):
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty):
        self.state["current_difficulty"] = difficulty

    def set_custom_get_difficulty(self, fn):
        self.custom_get_difficulty = fn
        self.state[CURRICULUM_LEARNING_SCHEDULE_TYPE] = CUSTOM

    def get_state(self):
        return self.state

    def set_state(self, state):
        self.state = state

    def __fixed_root_get_difficulty(self, global_steps, root_degree=None):
        cfg = self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        if root_degree is None:
            root_degree = cfg["root_degree"]
        next_difficulty = (min(1.0, global_steps /
                               cfg["total_curriculum_step"])) ** (1.0 / root_degree)
        next_difficulty = math.floor(
            next_difficulty *
            (self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY] -
             self.state[CURRICULUM_LEARNING_MIN_DIFFICULTY]) +
            self.state[CURRICULUM_LEARNING_MIN_DIFFICULTY])
        next_difficulty -= next_difficulty % cfg["difficulty_step"]
        return min(next_difficulty,
                   self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY])

    def __fixed_discrete_get_difficulty(self, global_steps):
        cfg = self.state[CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        for i, step in enumerate(cfg["max_step"]):
            if global_steps <= step:
                return cfg["difficulty"][i]
        return cfg["difficulty"][-1]

    def get_difficulty(self, global_steps):
        sched = self.state[CURRICULUM_LEARNING_SCHEDULE_TYPE]
        if sched == FIXED_ROOT:
            return self.__fixed_root_get_difficulty(global_steps)
        if sched == FIXED_LINEAR:
            return self.__fixed_root_get_difficulty(global_steps, 1)
        if sched == FIXED_DISCRETE:
            return self.__fixed_discrete_get_difficulty(global_steps)
        if sched == CUSTOM:
            return self.custom_get_difficulty(global_steps)
        raise RuntimeError(f"unsupported schedule type {sched}")

    def update_difficulty(self, global_steps):
        if self.state["current_difficulty"] < \
                self.state[CURRICULUM_LEARNING_MAX_DIFFICULTY]:
            self.state["current_difficulty"] = self.get_difficulty(global_steps)
        return self.state["current_difficulty"]


def _truncate(tree, seqlen):
    if isinstance(tree, dict):
        return {k: _truncate(v, seqlen) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_truncate(v, seqlen) for v in tree)
    if hasattr(tree, "ndim") and tree.ndim >= 2 and tree.shape[1] > seqlen:
        return tree[:, :seqlen]
    return tree


def apply_seqlen_truncation(scheduler, global_steps, batch):
    """Truncate axis 1 of every batch leaf of 2 or more dims (a tensor
    or a numpy array) to the difficulty scheduled for step
    ``global_steps + 1`` (the reference passes ``curriculum_seqlen`` to
    the forward, engine.py:1577; here, as in JAX, the batch is sliced).
    The slices are views."""
    seqlen = scheduler.update_difficulty(global_steps + 1)
    return _truncate(batch, seqlen)
