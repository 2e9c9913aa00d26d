"""Training monitor — TensorBoard, CSV, JSONL and Prometheus writers
(counterpart of ``deepspeed_tpu/monitor/monitor.py``).

The reference's rank-0 TensorBoard wiring; any exception while building
the TensorBoard writer (no ``tensorboard`` package, for one) falls back
to a CSV file, as the JAX monitor does. The ``telemetry`` block adds the
structured sinks (telemetry/sinks.py) as more backends. All backends
share ``write_scalar`` / ``flush`` / ``close``; ``MonitorMaster.close()``
(or the context manager) releases their files, and an ``atexit`` hook
closes a master nobody closed.
"""

import csv
import os


class TensorBoardMonitor:
    def __init__(self, output_path="runs/", job_name="DeepSpeedJobName"):
        from torch.utils.tensorboard import SummaryWriter
        os.makedirs(output_path, exist_ok=True)
        self.writer = SummaryWriter(log_dir=os.path.join(output_path,
                                                         job_name))

    def write_scalar(self, name, value, step):
        self.writer.add_scalar(name, value, step)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class CSVMonitor:
    def __init__(self, output_path="runs/", job_name="DeepSpeedJobName"):
        os.makedirs(output_path, exist_ok=True)
        self.path = os.path.join(output_path, f"{job_name}.csv")
        self._file = open(self.path, "a", newline="")
        self._writer = csv.writer(self._file)
        if self._file.tell() == 0:
            self._writer.writerow(["step", "name", "value"])

    def write_scalar(self, name, value, step):
        self._writer.writerow([step, name, float(value)])

    def flush(self):
        if not self._file.closed:
            self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class MonitorMaster:
    """Fans scalars out to every enabled backend (rank 0 only)."""

    def __init__(self, tensorboard_config=None, rank=0,
                 telemetry_config=None, metrics_registry=None):
        self.monitors = []
        self.enabled = rank == 0
        if not self.enabled:
            return
        if tensorboard_config is not None and tensorboard_config.enabled:
            path = tensorboard_config.output_path or "runs/"
            job = tensorboard_config.job_name or "DeepSpeedJobName"
            try:
                self.monitors.append(TensorBoardMonitor(path, job))
            except Exception:
                self.monitors.append(CSVMonitor(path, job))
        if telemetry_config is not None and telemetry_config.enabled:
            from deepspeed_tpu_torch.telemetry.sinks import (
                JSONLMonitor, PrometheusMonitor)
            path = telemetry_config.output_path or "telemetry/"
            job = telemetry_config.job_name or "DeepSpeedJobName"
            if telemetry_config.jsonl:
                self.monitors.append(JSONLMonitor(path, job))
            if telemetry_config.prometheus:
                # shares the TelemetryManager's registry so engine metrics
                # (step times, compile counts, ...) land in the same .prom
                self.monitors.append(PrometheusMonitor(
                    path, job, registry=metrics_registry))
        if self.monitors:
            # backends hold open file handles; a run that never tears the
            # engine down still flushes + closes at interpreter exit
            import atexit
            atexit.register(self.close)

    def write_events(self, event_list, flush=True):
        """event_list: [(name, value, step), ...] — reference signature."""
        if not self.enabled:
            return
        for name, value, step in event_list:
            for m in self.monitors:
                m.write_scalar(name, value, step)
        if flush:
            for m in self.monitors:
                m.flush()

    def close(self):
        """Flush and release every backend (idempotent)."""
        if not self.enabled:
            return
        for m in self.monitors:
            try:
                m.close()
            except Exception:
                pass
        # drop the exit hook so long-lived processes constructing many
        # masters (sweeps, test suites) don't pin closed instances
        import atexit
        try:
            atexit.unregister(self.close)
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
