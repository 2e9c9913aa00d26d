"""The background input pipeline: host prefetch and a CUDA copy stream
(counterpart of ``deepspeed_tpu/runtime/prefetch.py``).

:class:`PrefetchLoader` wraps an engine data source with a bounded
two-stage pipeline:

* **host stage**: worker threads fetch and collate the next ``depth``
  batches. A :class:`~deepspeed_tpu_torch.runtime.dataloader.
  DeepSpeedDataLoader` exposes its index plan and ``materialize``, so
  ``num_local_io_workers`` workers collate at once while a filler
  thread keeps the order; any other iterator gets one puller thread;
* **device stage**: a placement thread runs ``place_fn`` on batch N+1
  while step N computes. The engine's is :class:`CudaBatchPlacer`: it
  pins the host batch, copies it with ``non_blocking=True`` on a copy
  stream of its own and records an event. At the consumer's ``next()``
  the current stream waits on that event and every tensor is
  ``record_stream``-ed on it (:meth:`PlacedBatch.take`), so the step
  never reads a half-copied batch and the caching allocator does not
  hand the memory out while the step still reads it. The yielded batch
  is the same tree of tensors, now on the card.

No stage runs a collective: one process drives one rank, and the engine
runs every collective on the consumer's thread.

Properties held by ``tests/test_torch_dataloader.py``: the order is the
unwrapped loader's; at most ``depth`` batches are materialized; a
worker's or the placement's exception is raised at the consumer's
``next()`` in sequence position (the batches before it are delivered
first) and again on every later ``next()``; each ``iter()`` drains one
epoch, so a wrapping ``RepeatingLoader`` advances the epoch in order;
``close()`` stops and joins the (daemon) threads and is idempotent; an
iterator dropped mid-epoch is reclaimed by GC, because the threads hold
only the shared :class:`_PipelineState` and ``weakref.finalize`` stops
them.

``prefetch_hits_total`` / ``prefetch_misses_total`` (was the batch
ready when the consumer asked?) and the ``prefetch_depth_occupancy``
gauge go to the metrics registry (``telemetry/metrics.py``). The JAX
pipeline's threads also run under the goodput ledger's
``suppress_attribution``; the port has no ledger yet (ROADMAP A12).
"""

import queue
import threading
import weakref

import torch

from deepspeed_tpu_torch.telemetry import metrics as _metrics
from deepspeed_tpu_torch.utils.logging import logger

_END = "end"
_ERR = "err"
_OK = "ok"

# close()'s join grace a thread; they are daemon threads, so a hang in
# user collate or placement code leaks a daemon (with a warning) and
# never blocks the interpreter's exit
_JOIN_TIMEOUT_S = 5.0
_POLL_S = 0.2


class _Slot:
    """A minimal future: one materialized batch, or the exception its
    materialization raised (``concurrent.futures`` threads are not
    daemons and are joined at exit: a hung collate would block it)."""
    __slots__ = ("_ev", "_value", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._exc = None

    def set_result(self, value):
        self._value = value
        self._ev.set()

    def set_exception(self, exc):
        self._exc = exc
        self._ev.set()

    def done(self):
        return self._ev.is_set()

    def wait_ready(self, stop=None):
        """Block until the slot is filled; with ``stop``, poll so that a
        ``close()`` interrupts the wait. False iff stopped unfilled."""
        if stop is None:
            self._ev.wait()
            return True
        while not self._ev.wait(timeout=_POLL_S):
            if stop.is_set():
                return False
        return True

    def result(self):
        self._ev.wait()
        if self._exc is not None:
            raise self._exc
        return self._value


class _PipelineState:
    """What the pipeline threads share. The threads and the GC finalizer
    hold this object, never the iterator, so a dropped iterator is
    collected and its finalizer stops them."""
    __slots__ = ("stop", "sem", "hostq", "outq", "workq", "threads")

    def __init__(self, depth, device_stage):
        self.stop = threading.Event()
        self.sem = threading.Semaphore(depth)
        self.hostq = queue.Queue()
        self.outq = queue.Queue() if device_stage else self.hostq
        self.workq = None
        self.threads = []


def _wake_and_stop(state):
    """The stop flag and one wake sentinel a blocking wait site."""
    state.stop.set()
    n = max(1, len(state.threads))
    if state.workq is not None:
        for _ in range(n):
            state.workq.put(None)
    state.hostq.put(None)
    if state.outq is not state.hostq:
        # the device stage's hostq sentinel never reaches a consumer
        # blocked in outq.get()
        state.outq.put(None)
    state.sem.release(n)              # a filler parked on the depth gate


def _acquire_permit(state):
    """The depth semaphore's acquire, given up on stop."""
    while not state.stop.is_set():
        if state.sem.acquire(timeout=_POLL_S):
            return True
    return False


def _fill_indexed(state, loader):
    try:
        for idx in loader._index_plan():
            if not _acquire_permit(state):
                return
            slot = _Slot()
            state.workq.put((idx, slot))
            state.hostq.put((_OK, slot))
        state.hostq.put((_END, None))
    except BaseException as e:                 # a failure of the plan
        state.hostq.put((_ERR, e))


def _worker_loop(state, loader):
    while not state.stop.is_set():
        try:
            item = state.workq.get(timeout=_POLL_S)
        except queue.Empty:
            continue
        if item is None:              # close()'s wake sentinel
            return
        idx, slot = item
        try:
            slot.set_result(loader.materialize(idx))
        except BaseException as e:
            slot.set_exception(e)


def _fill_generic(state, src):
    while not state.stop.is_set():
        if not _acquire_permit(state):
            return
        try:
            batch = next(src)
        except StopIteration:
            state.hostq.put((_END, None))
            return
        except BaseException as e:
            state.hostq.put((_ERR, e))
            return
        state.hostq.put((_OK, batch))


def _device_loop(state, place_fn):
    while not state.stop.is_set():
        try:
            item = state.hostq.get(timeout=_POLL_S)
        except queue.Empty:
            continue
        if item is None:              # close()'s wake sentinel
            return
        kind, payload = item
        if kind != _OK:
            state.outq.put((kind, payload))
            return
        if isinstance(payload, _Slot) and \
                not payload.wait_ready(state.stop):
            return                    # closed with the slot never filled
        try:
            batch = payload.result() if isinstance(payload, _Slot) \
                else payload
            placed = place_fn(batch)
        except BaseException as e:
            state.outq.put((_ERR, e))
            return
        state.outq.put((_OK, placed))


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class PlacedBatch:
    """A batch whose copy to the card was issued on a copy stream, and
    the event recorded after it. :meth:`take` hands it to the consumer's
    current stream."""
    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device):
        self.batch = batch
        self.event = event
        self.device = device

    def take(self):
        """The batch, safe to read on the current stream: that stream
        waits on the copy's event, and each tensor is recorded as used
        by it (the allocator then keeps its memory until the stream's
        work is done, not only the copy stream's)."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in _tensors(self.batch):
            t.record_stream(stream)
        return self.batch


class CudaBatchPlacer:
    """The engine's device stage: ``place(batch)`` on the placement
    thread pins each CPU tensor of ``batch`` (a pageable source would
    make the copy synchronous) and copies it to ``device`` with
    ``non_blocking=True`` on a copy stream of the device, then records
    an event; returns a :class:`PlacedBatch`. A leaf that is not a
    tensor (a numpy array, a number) becomes one first, as the engine's
    ``_to_device`` makes it; a tensor already on the device is left as
    it is; a leaf that cannot be placed raises, and the consumer sees
    it at ``next()``. It runs no collective."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the copy-stream device stage needs a CUDA "
                             f"device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._stream = None
        self._lock = threading.Lock()

    def _copy(self, t):
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        if t.device == self.device:
            return t
        if t.device.type != "cpu":
            raise ValueError(f"a batch tensor on {t.device} cannot be "
                             f"placed on {self.device}")
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def __call__(self, batch):
        with torch.cuda.device(self.device):
            with self._lock:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                placed = _map_leaves(self._copy, batch)
                event = torch.cuda.Event()
                event.record(self._stream)
        return PlacedBatch(placed, event, self.device)


class PrefetchIterator:
    """One epoch's pipeline. Built by :class:`PrefetchLoader`; usable
    alone around any iterator (the engine wraps a ``data_iter`` given to
    ``train_batch`` in one)."""

    def __init__(self, source, depth=2, num_workers=1, place_fn=None,
                 loader=None, name="prefetch"):
        self.depth = max(1, int(depth))
        self._name = name
        self._finished = False
        self._closed = False
        self._error = None
        # indexed: the filler walks the loader's index plan and the
        # workers materialize; slots enter the host queue in plan order.
        # Generic: one puller owns the iterator (a generator cannot be
        # entered from two threads)
        indexed = _indexed(loader)
        workers = max(1, int(num_workers or 1))
        if not indexed and workers > 1:
            _warn_one_puller(source, workers)
            workers = 1
        workers = min(workers, self.depth)
        reg = _metrics.get_registry()
        self._hits = reg.counter(
            "prefetch_hits_total",
            "next() calls served by an already-materialized batch")
        self._misses = reg.counter(
            "prefetch_misses_total",
            "next() calls that had to wait on the input pipeline")
        self._occupancy = reg.gauge(
            "prefetch_depth_occupancy",
            "batches ready in the prefetch output queue at next()")

        state = self._state = _PipelineState(
            self.depth, device_stage=place_fn is not None)
        if indexed:
            state.workq = queue.Queue()
            for i in range(workers):
                self._spawn(_worker_loop, (state, loader), f"w{i}")
            self._spawn(_fill_indexed, (state, loader), "fill")
        else:
            self._spawn(_fill_generic, (state, iter(source)), "fill")
        if place_fn is not None:
            self._spawn(_device_loop, (state, place_fn), "place")
        # the dropped-iterator backstop: fires at GC and at interpreter
        # exit, and stops the pipeline without joining
        self._finalizer = weakref.finalize(self, _wake_and_stop, state)

    def _spawn(self, fn, args, tag):
        t = threading.Thread(target=fn, args=args,
                             name=f"ds-{self._name}-{tag}", daemon=True)
        self._state.threads.append(t)
        t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._error is not None:
            # a failed pipeline stays failed: StopIteration here would
            # silently cut the epoch short
            raise self._error
        if self._finished:
            raise StopIteration
        outq = self._state.outq
        try:
            item = outq.get_nowait()
            ready = True
        except queue.Empty:
            ready = False
            item = outq.get()
        if item is None:              # closed under a blocked consumer
            raise StopIteration
        kind, payload = item
        if kind == _END:
            self._finish()
            raise StopIteration
        if kind == _ERR:
            self._error = payload
            self._finish()
            raise payload
        if isinstance(payload, _Slot):
            # a hit: the materialization had finished when asked
            ready = ready and payload.done()
            if not payload.wait_ready(self._state.stop):
                raise StopIteration   # closed with the slot never filled
            try:
                payload = payload.result()
            except BaseException as e:
                self._error = e
                self._finish()
                raise
        if isinstance(payload, PlacedBatch):
            payload = payload.take()
        (self._hits if ready else self._misses).inc()
        self._occupancy.set(outq.qsize())
        self._state.sem.release()
        return payload

    def _finish(self):
        """The natural end (or an error): stop and join the threads."""
        self._finished = True
        self.close()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._finished = True
        _wake_and_stop(self._state)
        for t in self._state.threads:
            if t is threading.current_thread():
                continue
            t.join(timeout=_JOIN_TIMEOUT_S)
            if t.is_alive():
                logger.warning(
                    f"data_prefetch: thread {t.name} did not stop within "
                    f"{_JOIN_TIMEOUT_S}s (daemon; it cannot block exit)")
        self._finalizer.detach()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PrefetchLoader:
    """Loader-shaped wrapper: each ``iter()`` starts one
    :class:`PrefetchIterator` epoch pipeline over the wrapped loader.

    ``__len__``, ``set_epoch``, ``set_resume`` and ``.epoch`` go to the
    wrapped loader, so a surrounding ``RepeatingLoader`` (or a resume)
    sees the ordinary loader surface. ``close()`` stops every live
    pipeline; the loader is also a context manager."""

    def __init__(self, loader, depth=2, num_workers=1, place_fn=None,
                 name="prefetch"):
        self.loader = loader
        self.depth = depth
        if not _indexed(loader) and (num_workers or 1) > 1:
            # warned here once, not at each epoch's pipeline
            _warn_one_puller(loader, num_workers)
            num_workers = 1
        self.num_workers = num_workers
        self.place_fn = place_fn
        self._name = name
        self._iters = []                      # weakrefs to live pipelines

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        set_epoch = getattr(self.loader, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)

    def set_resume(self, batch_in_epoch):
        """The mid-epoch resume, passed to the wrapped loader's index
        plan: the next ``iter()``'s pipeline never schedules the skipped
        batches."""
        set_resume = getattr(self.loader, "set_resume", None)
        if set_resume is None:
            raise AttributeError(
                f"wrapped loader {type(self.loader).__name__!r} has no "
                f"set_resume; mid-epoch resume needs a "
                f"DeepSpeedDataLoader-style index plan")
        set_resume(batch_in_epoch)

    @property
    def epoch(self):
        return getattr(self.loader, "epoch", 0)

    def __iter__(self):
        it = PrefetchIterator(
            self.loader, depth=self.depth, num_workers=self.num_workers,
            place_fn=self.place_fn,
            loader=self.loader if _indexed(self.loader) else None,
            name=self._name)
        self._iters = [r for r in self._iters if r() is not None]
        self._iters.append(weakref.ref(it))
        return it

    def close(self):
        for ref in self._iters:
            it = ref()
            if it is not None:
                it.close()
        self._iters = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _indexed(loader):
    """The loader splits its index plan from the fetch, so several host
    workers can materialize while one filler keeps the order."""
    return (loader is not None and hasattr(loader, "_index_plan")
            and hasattr(loader, "materialize"))


def _warn_one_puller(source, workers):
    logger.warning(
        f"data_prefetch: source {type(source).__name__!r} is not an "
        f"indexable DeepSpeedDataLoader; the host stage runs ONE puller "
        f"thread (iterators are not concurrently re-entrant), ignoring "
        f"num_local_io_workers={workers}")
