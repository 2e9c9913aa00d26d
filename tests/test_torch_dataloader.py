"""The port's loaders and prefetch pipeline on the CPU
(``deepspeed_tpu_torch/runtime/{dataloader,prefetch}.py``).

The loaders against the JAX package's (``deepspeed_tpu/runtime/
dataloader.py``) on the same datasets: the index streams (each epoch's
plan, through ``RepeatingLoader`` across wrap-arounds) must be equal and
the collated values exact, in every parametrised case, and so must the
position a ``state_dict`` saves and the stream that ``load_state_dict``
resumes. The prefetch pipeline with a CPU ``place_fn``: the order is the
unwrapped loader's, at most ``depth`` batches are materialized, an error
is raised in position and again after, ``close()`` leaves no thread, a
dropped iterator is reclaimed by GC. (The copy-stream device stage runs
on the card: ``tests/test_torch_cuda_data.py``.)
"""

import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader,
                                                    _default_collate)
from deepspeed_tpu_torch.runtime.prefetch import (PrefetchIterator,
                                                  PrefetchLoader)
from deepspeed_tpu_torch.telemetry.metrics import get_registry


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("ds-prefetch")]


def _assert_no_threads(timeout=3.0):
    """The pipeline threads poll at 0.2 s; give them a moment."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _prefetch_threads():
            return
        time.sleep(0.02)
    raise AssertionError(f"leaked prefetch threads: "
                         f"{[t.name for t in _prefetch_threads()]}")


@pytest.fixture(autouse=True)
def _no_thread_leaks():
    yield
    _assert_no_threads()


# ------------------------------------------------------------ datasets


class _Samples:
    """Sample i of a kind: its index recoverable from the values."""

    def __init__(self, n, kind):
        self.n, self.kind = n, kind
        rng = np.random.default_rng(n)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.kind == "dict":
            return {"ids": np.arange(4, dtype=np.int64) + 10 * i,
                    "x": self.x[i]}
        if self.kind == "tuple":
            return (self.x[i], np.float64(i))
        return i                                    # a scalar sample


def _first_ids(batch):
    """The sample indices a collated batch holds."""
    if isinstance(batch, dict):
        return (np.asarray(batch["ids"])[:, 0] // 10).tolist()
    if isinstance(batch, tuple):
        return np.asarray(batch[1]).astype(int).tolist()
    return np.asarray(batch).tolist()


def _same_values(got, want):
    """A port batch (CPU tensors) equals a JAX batch (numpy): structure,
    dtypes and values exact."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same_values(got[k], want[k])
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_values(g, w)
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


class _Sampler:
    """A user sampler: every third index, reversed (used verbatim)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(range(self.n - 1, -1, -3))


def _collate_sum(samples):
    return torch.tensor([sum(int(s) for s in samples)])


def _jax_collate_sum(samples):
    return np.array([sum(int(s) for s in samples)])


# (name, dataset size, sample kind, loader kwargs)
LOADER_CASES = [
    ("plain", 24, "scalar", dict(batch_size=4)),
    ("shuffle", 24, "scalar", dict(batch_size=4, shuffle=True, seed=3)),
    ("drop_last", 26, "scalar", dict(batch_size=4, shuffle=True,
                                     drop_last=True)),
    ("keep_last", 26, "scalar", dict(batch_size=4, shuffle=True,
                                     drop_last=False)),
    ("sampler", 26, "scalar", dict(batch_size=3, data_sampler="sampler")),
    ("sampler_keep_last", 26, "scalar", dict(batch_size=4,
                                             data_sampler="sampler",
                                             drop_last=False)),
    ("dict", 20, "dict", dict(batch_size=4, shuffle=True, seed=1)),
    ("tuple", 20, "tuple", dict(batch_size=5, shuffle=True)),
    ("custom_collate", 20, "scalar", dict(batch_size=4, shuffle=True,
                                          collate_fn="sum")),
] + [(f"slice{r}of{c}", 37, "dict",
      dict(batch_size=3, shuffle=True, seed=5, process_index=r,
           process_count=c, drop_last=r % 2 == 0))
     for c in (2, 4) for r in range(c)]


def _loaders(n, kind, kw):
    ds = _Samples(n, kind)
    port_kw, jax_kw = dict(kw), dict(kw)
    if kw.get("data_sampler") == "sampler":
        port_kw["data_sampler"] = jax_kw["data_sampler"] = _Sampler(n)
    if kw.get("collate_fn") == "sum":
        port_kw["collate_fn"] = _collate_sum
        jax_kw["collate_fn"] = _jax_collate_sum
    return (DeepSpeedDataLoader(ds, **port_kw),
            jax_dl.DeepSpeedDataLoader(ds, **jax_kw))


@pytest.mark.parametrize("name,n,kind,kw", LOADER_CASES,
                         ids=[c[0] for c in LOADER_CASES])
def test_loader_stream_equals_jax(name, n, kind, kw):
    """Three epochs through ``RepeatingLoader`` (the wrap-arounds
    reshuffle through ``set_epoch``): each epoch's index plan equal, every
    batch's values exact, the lengths and epoch counters equal."""
    port, ref = _loaders(n, kind, kw)
    assert len(port) == len(ref) > 0
    for epoch in range(3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert [p.tolist() for p in port._index_plan()] == \
            [p.tolist() for p in ref._index_plan()]
    port, ref = _loaders(n, kind, kw)
    rp, rr = RepeatingLoader(port), jax_dl.RepeatingLoader(ref)
    seen = []
    for _ in range(3 * len(port)):
        got, want = next(rp), next(rr)
        _same_values(got, want)
        seen.append(_first_ids(want) if kw.get("collate_fn") is None
                    else None)
        assert rp.state_dict() == rr.state_dict()
    # (``len`` counts the dataset's share, in JAX as in the reference,
    # so a sampler's or a short slice's epoch can end before it)
    assert rp.epoch == rr.epoch == port.epoch == ref.epoch >= 2
    if kw.get("shuffle") and kw.get("collate_fn") is None:
        per = len(port)
        assert seen[:per] != seen[per:2 * per]      # the order moved


def test_default_collate_of_tensors_and_arrays():
    """Torch samples stack as torch; scalars and arrays through numpy, in
    JAX's dtypes."""
    out = _default_collate([{"a": torch.ones(2), "b": 1.5},
                            {"a": torch.zeros(2), "b": 2.5}])
    assert out["a"].tolist() == [[1, 1], [0, 0]]
    assert out["b"].dtype == torch.float64
    _same_values(_default_collate([(np.int32(1), [1, 2]), (np.int32(2),
                                                           [3, 4])]),
                 jax_dl._default_collate([(np.int32(1), [1, 2]),
                                          (np.int32(2), [3, 4])]))


# (name, dataset size, loader kwargs, batches consumed before the save)
RESUME_CASES = [
    ("mid_epoch", 40, dict(batch_size=4, shuffle=True, seed=2), 3),
    ("second_epoch", 40, dict(batch_size=4, shuffle=True), 13),
    ("epoch_end", 40, dict(batch_size=4, shuffle=True), 10),
    ("slice1of2", 41, dict(batch_size=3, shuffle=True, process_index=1,
                           process_count=2), 8),
    ("sampler", 30, dict(batch_size=2, data_sampler="sampler"), 3),
]


@pytest.mark.parametrize("name,n,kw,consumed", RESUME_CASES,
                         ids=[c[0] for c in RESUME_CASES])
@pytest.mark.parametrize("prefetch", [False, True])
def test_resume_equals_jax(name, n, kw, consumed, prefetch):
    """``state_dict`` after ``consumed`` batches equals JAX's; a fresh
    loader given it by ``load_state_dict`` yields the uninterrupted
    stream, as the JAX loader resumed from the same state does. With
    ``prefetch`` the port's loader is a ``PrefetchLoader`` (the skip goes
    to its index plan)."""
    def port_loader():
        p, _ = _loaders(n, "scalar", kw)
        return PrefetchLoader(p, depth=2, num_workers=2) if prefetch else p

    ref = jax_dl.RepeatingLoader(_loaders(n, "scalar", kw)[1])
    whole = [np.asarray(next(ref)).tolist() for _ in range(consumed + 6)]
    first = port_loader()
    rp = RepeatingLoader(first)
    for _ in range(consumed):
        next(rp)
    state = rp.state_dict()
    rr = jax_dl.RepeatingLoader(_loaders(n, "scalar", kw)[1])
    for _ in range(consumed):
        next(rr)
    assert state == rr.state_dict()
    resumed = port_loader()
    rp2 = RepeatingLoader(resumed)
    rp2.load_state_dict(state)
    rr2 = jax_dl.RepeatingLoader(_loaders(n, "scalar", kw)[1])
    rr2.load_state_dict(state)
    got = [next(rp2).tolist() for _ in range(6)]
    assert got == [np.asarray(next(rr2)).tolist() for _ in range(6)]
    assert got == whole[consumed:]
    assert rp2.state_dict() == rr2.state_dict()
    if prefetch:
        first.close()
        resumed.close()


def test_set_resume_fetches_nothing_it_skips():
    class Counting(_Samples):
        fetched = []

        def __getitem__(self, i):
            self.fetched.append(i)
            return super().__getitem__(i)

    ds = Counting(32, "scalar")
    loader = DeepSpeedDataLoader(ds, batch_size=4)
    loader.set_resume(6)
    assert [b.tolist() for b in loader] == [[24, 25, 26, 27],
                                            [28, 29, 30, 31]]
    assert ds.fetched == list(range(24, 32))
    assert len(list(loader)) == 8                   # one-shot


# ------------------------------------------------------------- prefetch


def _int_loader(n=32, batch_size=4, **kw):
    return DeepSpeedDataLoader(list(range(n)), batch_size=batch_size, **kw)


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("place", [False, True])
def test_prefetch_order_equals_unwrapped(workers, place):
    base = [b.tolist() for b in _int_loader(shuffle=True, seed=3)]
    pl = PrefetchLoader(_int_loader(shuffle=True, seed=3), depth=2,
                        num_workers=workers,
                        place_fn=(lambda b: b + 1000) if place else None)
    with pl:
        got = [b.tolist() for b in pl]
    assert got == ([[x + 1000 for x in b] for b in base] if place
                   else base)


def test_prefetch_repeating_epochs_equal_unwrapped():
    def epochs(loader):
        rl = RepeatingLoader(loader)
        return [next(rl).tolist() for _ in range(24)]

    base = epochs(_int_loader(shuffle=True))
    pl = PrefetchLoader(_int_loader(shuffle=True), depth=3, num_workers=2,
                        place_fn=lambda b: b)
    with pl:
        assert epochs(pl) == base
    assert pl.epoch == 2


def test_prefetch_generic_iterator_and_exhaustion():
    it = PrefetchIterator(iter(range(5)), depth=2, num_workers=3)
    assert list(it) == [0, 1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(it)                                    # stays exhausted
    _assert_no_threads()


class _CountingDataset:
    """dataset[i] == i, counting the fetches."""

    def __init__(self, n, delay=0.0):
        self.n, self.delay = n, delay
        self.calls = 0
        self._lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        with self._lock:
            self.calls += 1
        return i


@pytest.mark.parametrize("depth,workers", [(1, 1), (2, 2), (3, 2)])
def test_prefetch_never_more_than_depth_materialized(depth, workers):
    bs = 4
    ds = _CountingDataset(64)
    with PrefetchLoader(DeepSpeedDataLoader(ds, batch_size=bs),
                        depth=depth, num_workers=workers,
                        place_fn=lambda b: b) as pl:
        it = iter(pl)
        for consumed in range(1, 4):
            next(it)
            time.sleep(0.15)            # let the pipeline run ahead
            assert ds.calls <= (consumed + depth) * bs
        assert ds.calls == (3 + depth) * bs     # and it did run ahead


class _Boom(RuntimeError):
    pass


def test_prefetch_generic_error_in_position_and_after():
    def gen():
        yield 1
        yield 2
        raise _Boom("source died")

    it = PrefetchIterator(gen(), depth=2, place_fn=lambda b: b)
    assert [next(it), next(it)] == [1, 2]
    for _ in range(2):                  # a failed pipeline stays failed
        with pytest.raises(_Boom, match="source died"):
            next(it)


def test_prefetch_worker_error_in_position_and_after():
    class Poison(_CountingDataset):
        def __getitem__(self, i):
            if i == 9:                  # batch 2 at bs 4
                raise _Boom("bad sample")
            return super().__getitem__(i)

    with PrefetchLoader(DeepSpeedDataLoader(Poison(32), batch_size=4),
                        depth=2, num_workers=2) as pl:
        it = iter(pl)
        assert next(it).tolist() == [0, 1, 2, 3]
        assert next(it).tolist() == [4, 5, 6, 7]
        for _ in range(2):
            with pytest.raises(_Boom, match="bad sample"):
                next(it)


def test_prefetch_place_error_in_position_and_after():
    def place(b):
        if b == 3:
            raise _Boom("placement failed")
        return b

    it = PrefetchIterator(iter(range(6)), depth=2, place_fn=place)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    for _ in range(2):
        with pytest.raises(_Boom, match="placement failed"):
            next(it)


def test_prefetch_hits_and_misses_are_counted():
    reg = get_registry()
    hits = reg.counter("prefetch_hits_total")
    misses = reg.counter("prefetch_misses_total")
    h0, m0 = hits.value, misses.value
    with PrefetchLoader(DeepSpeedDataLoader(_CountingDataset(16, 0.01),
                                            batch_size=4), depth=2) as pl:
        it = iter(pl)
        next(it)                        # cold: a miss
        time.sleep(0.3)
        next(it)                        # ready: a hit
        list(it)
    assert hits.value - h0 + misses.value - m0 == 4
    assert hits.value > h0 and misses.value > m0


def test_prefetch_stress_more_workers_than_cores():
    """16 host workers (more than the cores) at depth 16 with a 1 µs
    switch interval: every batch arrives once and in the unwrapped
    order, each sample is fetched once, and the hit and miss counters
    add up to the batches taken (a lost update or a slot out of order
    breaks one of them). Bounded by the join timeouts."""
    reg = get_registry()
    hits = reg.counter("prefetch_hits_total")
    misses = reg.counter("prefetch_misses_total")
    taken0 = hits.value + misses.value
    ds = _CountingDataset(1000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with PrefetchLoader(DeepSpeedDataLoader(ds, batch_size=2,
                                                shuffle=True, seed=9),
                            depth=16, num_workers=16,
                            place_fn=lambda b: b) as pl:
            got = [b.tolist() for b in pl]
    finally:
        sys.setswitchinterval(old)
    want = [b.tolist() for b in DeepSpeedDataLoader(
        list(range(1000)), batch_size=2, shuffle=True, seed=9)]
    assert got == want and ds.calls == 1000
    assert hits.value + misses.value - taken0 == 500


def test_prefetch_close_joins_and_is_idempotent():
    pl = PrefetchLoader(_int_loader(n=1024), depth=2, num_workers=2,
                        place_fn=lambda b: b)
    it = iter(pl)
    next(it)
    assert _prefetch_threads()
    pl.close()
    assert not _prefetch_threads()      # joined, not left to drain
    it.close()
    pl.close()
    with PrefetchIterator(iter([1, 2, 3]), depth=2) as it2:
        assert next(it2) == 1


def test_prefetch_close_wakes_a_blocked_consumer():
    """close() with slots that no worker will fill, and a consumer
    blocked in the output queue of the device stage: neither hangs."""
    def slow_collate(samples):
        time.sleep(0.25)
        return _default_collate(samples)

    pl = PrefetchLoader(DeepSpeedDataLoader(list(range(256)), batch_size=4,
                                            collate_fn=slow_collate),
                        depth=4, num_workers=2, place_fn=lambda b: b)
    it = iter(pl)
    got = []

    def consume():
        try:
            while True:
                got.append(next(it))
        except StopIteration:
            got.append("stopped")

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    pl.close()
    assert time.monotonic() - t0 < 3.0
    consumer.join(timeout=3.0)
    assert not consumer.is_alive() and got[-1] == "stopped"


def test_prefetch_abandoned_iterator_is_reclaimed_by_gc():
    pl = PrefetchLoader(_int_loader(n=1024), depth=2, num_workers=2,
                        place_fn=lambda b: b)
    it = iter(pl)
    next(it)
    assert _prefetch_threads()
    del it
    pl._iters = []                      # the loader's weakref too
    gc.collect()
    _assert_no_threads()


def test_prefetch_close_with_a_parked_filler():
    pl = PrefetchLoader(_int_loader(n=256), depth=1)
    iter(pl)
    time.sleep(0.1)                     # the filler waits on the gate
    t0 = time.monotonic()
    pl.close()
    assert time.monotonic() - t0 < 3.0


def test_prefetch_loader_delegates_the_loader_surface():
    inner = _int_loader(shuffle=True)
    pl = PrefetchLoader(inner, depth=2)
    assert len(pl) == len(inner) == 8
    pl.set_epoch(5)
    assert inner.epoch == pl.epoch == 5
    pl.set_resume(7)
    with pl:
        assert len(list(pl)) == 1
    with pytest.raises(AttributeError, match="set_resume"):
        PrefetchLoader([[1], [2]]).set_resume(1)
    # a plain iterable has one puller, whatever the workers asked
    generic = PrefetchLoader([[1], [2]], num_workers=3)
    assert generic.num_workers == 1
    with generic:
        assert list(generic) == [[1], [2]]


def test_cuda_placer_takes_only_a_cuda_device():
    """The copy-stream stage is for a card; the CPU engine places with
    ``_to_device`` instead (its tests: tests/test_torch_cuda_data.py)."""
    from deepspeed_tpu_torch.runtime.prefetch import CudaBatchPlacer
    with pytest.raises(ValueError, match="CUDA device"):
        CudaBatchPlacer("cpu")
