"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``; the reference ``deepspeed/utils/timer.py``
``SynchronizedWallClockTimer`` timer.py:23, ``ThroughputTimer`` :122).

The breakdown timers call ``torch.cuda.synchronize()`` at start and stop,
as the reference's do; the engine starts them only while
``wall_clock_breakdown`` is on. The throughput timer adds no
synchronization: the JAX timer's ``effects_barrier`` waits only for
effectful programs, and a CUDA launch has none, so its host timestamps
over ``steps_per_output`` steps stand as they are.
"""

import time

from deepspeed_tpu_torch.utils.logging import log_dist

try:
    import psutil
    PSUTIL_AVAILABLE = True
except ImportError:
    PSUTIL_AVAILABLE = False


def _device_synchronize():
    """Wait for every stream of the current card (nothing without an
    initialised CUDA context: a CPU run has nothing to wait for)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Group of named timers, each synchronising the device on start/stop."""

    class Timer:
        def __init__(self, name):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = time.time()

        def start(self):
            assert not self.started_, f"{self.name_} timer has already been started"
            _device_synchronize()
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False, record=False):
            """``record=True`` additionally observes this start->stop
            interval into the telemetry metrics registry (histogram
            ``timer_<name>_ms``) — the reference's dead parameter, given
            the recording semantics its name promises."""
            assert self.started_, "timer is not started"
            _device_synchronize()
            interval = time.time() - self.start_time
            if reset:
                self.elapsed_ = interval
            else:
                self.elapsed_ += interval
            self.started_ = False
            if record:
                from deepspeed_tpu_torch.telemetry.metrics import \
                    get_registry
                get_registry().histogram(
                    f"timer_{self.name_}_ms",
                    "SynchronizedWallClockTimer recorded intervals"
                ).observe(interval * 1000.0)

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started_ = self.started_
            if self.started_:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started_:
                self.start()
            return elapsed_

        def mean(self):
            return self.elapsed(reset=False)

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    @staticmethod
    def memory_usage():
        if not PSUTIL_AVAILABLE:
            return "mem stats unavailable"
        vm = psutil.virtual_memory()
        return f"host mem used: {vm.used / (1024**3):.2f} GB ({vm.percent}%)"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += " | {}: {:.2f}".format(name, elapsed_time)
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        means = {}
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].mean() * 1000.0 / normalizer
                means[name] = elapsed_time
        return means


class ThroughputTimer:
    """Samples/sec timer mirroring the reference's ThroughputTimer."""

    def __init__(self, batch_size, start_step=2, steps_per_output=50, monitor_memory=False, logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn
        if self.logging is None:
            from deepspeed_tpu_torch.utils.logging import logger
            self.logging = logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.time()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration

            if global_step:
                if report_speed and self.global_step_count % self.steps_per_output == 0:
                    # clock-resolution zero (or an all-warmup window) must
                    # not crash the log line
                    curr = (self.batch_size / self.step_elapsed_time
                            if self.step_elapsed_time > 0 else 0.0)
                    self.logging(
                        "epoch={}/micro_step={}/global_step={}, RunningAvgSamplesPerSec={}, "
                        "CurrSamplesPerSec={}".format(
                            self.epoch_count, self.micro_step_count, self.global_step_count,
                            self.avg_samples_per_sec(), curr))
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        """0.0 before any timed step (warmup: the first ``start_step``
        steps are untimed) — not the reference's ``-inf``, which poisoned
        every consumer that averaged or formatted it."""
        if self.total_elapsed_time > 0:
            total_step_offset = self.global_step_count - self.start_step
            avg_time_per_step = self.total_elapsed_time / max(1, total_step_offset)
            return self.batch_size / avg_time_per_step
        return 0.0
