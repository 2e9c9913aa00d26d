"""Background checkpoint persistence (counterpart of
``deepspeed_tpu/runtime/async_checkpoint.py``).

Under ``checkpoint.async_save`` a save is split in two: the snapshot
(device -> host copies that own their bytes, at the step boundary; the
only part the training loop waits for) and the persist (pickle, fsync,
rename, manifest, ``latest``), which this writer runs on a background
thread while training continues.

Over a process group each rank runs its own writer and persists its own
shard file; rank 0's persist writes the manifest and ``latest`` only once
every rank's file is on disk (``checkpoint_io.wait_for_files``, file
polling: the thread runs no collective). A failure on any rank is raised
at that rank's next save, load or ``close``.

The contract, as in JAX:

* at most one persist is in flight: ``submit`` drains the previous one
  first, so two saves never interleave files or race ``latest``;
* a persist that raises ``OSError`` (or anything else) is run again up
  to ``retries`` times with jittered exponential backoff, each retry
  counted into ``checkpoint_retries_total``;
* a background failure is never silent: it re-raises, wrapped in
  :class:`AsyncCheckpointError`, at the next ``submit`` / ``drain`` /
  ``close`` (the engine drains at every save and load);
* the thread holds only the shared :class:`_WriterState`, never the
  engine; a ``weakref.finalize`` joins an in-flight persist (bounded) at
  interpreter exit, so a normal exit does not cut a checkpoint short.

The JAX writer books nothing of the thread's time into its goodput
ledger; the ledger is not ported, so there is nothing to suppress here.
"""

import random
import threading
import time
import weakref

from deepspeed_tpu_torch.telemetry.metrics import get_registry
from deepspeed_tpu_torch.utils.logging import logger

_EXIT_JOIN_TIMEOUT_S = 120.0


class AsyncCheckpointError(RuntimeError):
    """A background checkpoint persist failed; raised at the next
    save / drain / close."""


class _WriterState:
    __slots__ = ("thread", "error", "tag")

    def __init__(self):
        self.thread = None
        self.error = None
        self.tag = None


def _finalize_state(state):
    t = state.thread
    if t is not None and t.is_alive():
        t.join(timeout=_EXIT_JOIN_TIMEOUT_S)
        if t.is_alive():
            logger.warning(
                f"async checkpoint: background write of tag {state.tag!r} "
                f"did not finish within {_EXIT_JOIN_TIMEOUT_S:.0f}s at "
                f"shutdown; the tag will be left without a manifest "
                f"(detectably incomplete)")


class AsyncCheckpointWriter:
    """One background persist at a time; the engine builds it on its
    first save under ``checkpoint.async_save``."""

    def __init__(self, name="ckpt-writer", retries=0, backoff_s=0.05):
        self._name = name
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))
        self._state = _WriterState()
        self._closed = False
        self._finalizer = weakref.finalize(self, _finalize_state,
                                           self._state)

    @property
    def in_flight(self):
        t = self._state.thread
        return t is not None and t.is_alive()

    def submit(self, persist_fn, tag=""):
        """Drain the previous persist (re-raising its failure), then run
        ``persist_fn()`` on a new background thread."""
        self.drain()
        if self._closed:
            raise AsyncCheckpointError(
                "async checkpoint writer is closed (engine.close() ran)")
        state = self._state
        state.tag = str(tag)
        retries, backoff_s = self.retries, self.backoff_s

        def _run():
            try:
                for attempt in range(retries + 1):
                    try:
                        persist_fn()
                        break
                    except Exception as e:
                        # every file write is atomic (tmp + rename), so
                        # the whole persist can run again
                        if attempt >= retries:
                            raise
                        get_registry().counter(
                            "checkpoint_retries_total",
                            "checkpoint persist attempts retried after a "
                            "transient failure").inc()
                        delay = (backoff_s * (2 ** attempt)
                                 * (0.5 + random.random()))
                        logger.warning(
                            f"async checkpoint: persist of tag "
                            f"{state.tag!r} failed (attempt {attempt + 1}/"
                            f"{retries + 1}: {e}); retrying in "
                            f"{delay:.3f}s")
                        if delay > 0:
                            time.sleep(delay)
            except BaseException as e:      # surfaced at the next drain
                state.error = e

        t = threading.Thread(target=_run, name=f"ds-{self._name}",
                             daemon=True)
        state.thread = t
        t.start()

    def drain(self):
        """Wait for the in-flight persist, if any, and re-raise its
        failure. Idempotent."""
        state = self._state
        t = state.thread
        if t is not None:
            t.join()
            state.thread = None
        err = state.error
        if err is not None:
            state.error = None
            raise AsyncCheckpointError(
                f"background checkpoint write of tag {state.tag!r} "
                f"failed: {err}") from err

    def close(self):
        """Drain and refuse further submits; re-raises a pending
        background failure."""
        self._closed = True
        try:
            self.drain()
        finally:
            if self._state.thread is None:
                self._finalizer.detach()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
