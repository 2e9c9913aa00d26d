"""The prefetch pipeline's device stage on the card
(``runtime/prefetch.CudaBatchPlacer``): pinned host batches copied on a
copy stream, handed to the consumer's stream at ``next()``. Every test
carries the ``cuda`` marker and skips without a card. This file imports
no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_data.py

The placed batches must be bit-equal to ``.to(device)`` of the same
batches, also when the consumer's stream is busy: a consumer stream that
has not yet read a batch when its Python reference is dropped keeps the
memory (``record_stream``), and a read issued right after ``next()``
while the copy stream is held back sees the whole copy (the stream
waits on the copy's event). Each of the two tests fails when
``PlacedBatch.take`` leaves out its half (checked on an H100 by
patching ``take`` at run time). A placement that fails raises at
``next()`` in sequence position. The engine fed
through ``initialize(training_data=)`` with the device stage gives the
losses of the same batches pre-placed, bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.prefetch import (CudaBatchPlacer,
                                                  PrefetchIterator,
                                                  PrefetchLoader)

pytestmark = pytest.mark.cuda

CFG = gpt2.GPT2Config(vocab_size=512, n_positions=256, n_embd=256,
                      n_layer=2, n_head=4)


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("ds-prefetch")]


class _Samples:
    """Dict samples: int64 ids, a float32 row of ``width`` and a bool
    mask, made from the index."""

    def __init__(self, n, width=64):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        x = np.arange(self.width, dtype=np.float32) * np.float32(0.5) + i
        return {"ids": rng.integers(0, 1 << 40, 16), "x": x,
                "mask": rng.random(16) < 0.5}


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "cuda"
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k].to("cuda")), k


@pytest.mark.parametrize("workers,depth", [(1, 1), (2, 2), (4, 3)])
def test_placed_batches_equal_plain_copies(workers, depth):
    """Two epochs through RepeatingLoader: each placed batch is
    bit-equal to the unwrapped loader's batch copied by .to("cuda")."""
    plain = RepeatingLoader(DeepSpeedDataLoader(_Samples(40), 8,
                                                shuffle=True))
    pl = PrefetchLoader(DeepSpeedDataLoader(_Samples(40), 8, shuffle=True),
                        depth=depth, num_workers=workers,
                        place_fn=CudaBatchPlacer("cuda"))
    placed = RepeatingLoader(pl)
    for _ in range(10):
        _same(next(placed), next(plain))
    pl.close()
    assert not _prefetch_threads()


@pytest.mark.parametrize("side_stream", [False, True])
def test_busy_consumer_stream_reads_whole_batches(side_stream):
    """64 MB batches, read by a clone on the consumer's stream (the
    default one, or a side stream current at next()) and dropped at
    once; a sleep kernel of ~100 ms after each read keeps that stream
    busy, so the host runs batches ahead of the reads. The first read
    is issued while its copy is in flight (the pipeline starts cold):
    it must wait on the copy's event. The later reads run long after
    their batches were dropped, while the placement thread copies the
    next batches: the dropped memory must not be handed to those copies
    (record_stream). All reads are checked after one synchronise."""
    width = 1 << 21
    n = 12
    stream = torch.cuda.Stream() if side_stream else \
        torch.cuda.current_stream()
    pl = PrefetchLoader(DeepSpeedDataLoader(_Samples(8 * n, width), 8),
                        depth=3, num_workers=2,
                        place_fn=CudaBatchPlacer("cuda"))
    reads = []
    with torch.cuda.stream(stream):
        for batch in pl:
            reads.append(batch["x"].clone())
            del batch
            torch.cuda._sleep(200_000_000)
    torch.cuda.synchronize()
    want = list(DeepSpeedDataLoader(_Samples(8 * n, width), 8))
    assert len(reads) == n
    for got, w in zip(reads, want):
        assert torch.equal(got.cpu(), w["x"])
    pl.close()


@pytest.mark.parametrize("side_stream", [False, True])
def test_read_right_after_next_waits_for_a_slow_copy(side_stream):
    """The copy stream is held back by a ~100 ms sleep kernel queued
    before the first batch's copy, so next() returns while the copy has
    not run; a read issued at once on the consumer's stream must still
    see the whole batch (the stream waits on the copy's event)."""
    placer = CudaBatchPlacer("cuda")
    placer._stream = torch.cuda.Stream()
    with torch.cuda.stream(placer._stream):
        torch.cuda._sleep(200_000_000)
    stream = torch.cuda.Stream() if side_stream else \
        torch.cuda.current_stream()
    batches = [{"x": torch.arange(1 << 20, dtype=torch.float32) + k}
               for k in range(3)]
    with torch.cuda.stream(stream):
        reads = [b["x"].clone() for b in PrefetchIterator(
            iter(batches), depth=2, place_fn=placer)]
    torch.cuda.synchronize()
    for got, want in zip(reads, batches):
        assert torch.equal(got.cpu(), want["x"])


def test_already_placed_and_non_tensor_leaves():
    placer = CudaBatchPlacer("cuda")
    on_card = torch.arange(4, device="cuda")
    it = PrefetchIterator(iter([(on_card, np.arange(3), 2.5)]), depth=1,
                          place_fn=placer)
    got, arr, num = next(it)
    assert got is on_card                        # left as it is
    assert arr.device.type == num.device.type == "cuda"
    assert arr.tolist() == [0, 1, 2] and float(num) == 2.5
    it.close()


def test_failed_placement_raises_at_next_in_position():
    """A batch that cannot be placed (a tensor on the meta device) raises
    at the consumer's next(), after the batches before it, and again."""
    good = {"x": torch.ones(4)}
    bad = {"x": torch.empty(4, device="meta")}
    it = PrefetchIterator(iter([good, good, bad, good]), depth=2,
                          place_fn=CudaBatchPlacer("cuda"))
    assert [next(it)["x"].sum().item() for _ in range(2)] == [4.0, 4.0]
    for _ in range(2):
        with pytest.raises(ValueError, match="cannot be placed"):
            next(it)


class _Rows:
    def __init__(self, n, seq):
        rng = np.random.default_rng(11)
        self.ids = rng.integers(0, CFG.vocab_size, (n, seq))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


def test_engine_prefetched_equals_preplaced():
    """initialize(training_data=) with the device stage, 5 steps across
    a wrap-around, against the same batches (the plain loader's order)
    pre-placed on the card: losses and masters bit-equal; close() leaves
    no pipeline thread."""
    config = {"train_batch_size": 4, "steps_per_print": 10 ** 9,
              "bf16": {"enabled": True},
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                       "fused": True}},
              "data_prefetch": {"enabled": True, "depth": 2}}
    data = _Rows(16, 128)
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(CFG, seed=0), config=dict(config),
        training_data=data)
    assert isinstance(loader.place_fn, CudaBatchPlacer)
    it = RepeatingLoader(loader)
    got = [float(engine.train_batch(data_iter=it)) for _ in range(5)]
    config["data_prefetch"] = {"enabled": False}
    ref, _, plain, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.GPT2LMHeadModel(CFG, seed=0), config=config,
        training_data=data)
    rit = RepeatingLoader(plain)
    batches = [{k: v.to("cuda") for k, v in next(rit).items()}
               for _ in range(5)]
    torch.cuda.synchronize()
    want = [float(ref.train_batch(batch=b)) for b in batches]
    assert got == want
    for k, p in engine.params.items():
        assert torch.equal(p, ref.params[k]), k
    engine.close()
    assert not _prefetch_threads()
