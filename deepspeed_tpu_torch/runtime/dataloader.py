"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``;
reference ``deepspeed/runtime/dataloader.py``: ``DeepSpeedDataLoader``
:33, ``RepeatingLoader`` :10).

One process is one rank: each loader yields this rank's micro-batches,
the ``process_index``-strided slice of the epoch's order
(``DistributedSampler`` semantics), with ``process_index`` /
``process_count`` the rank and size of the data group. The index stream
(order, slices, resume position) is the JAX loader's for the same
dataset, seed, epoch and slice. Batches are CPU torch tensors; the
engine (or the prefetch device stage, ``runtime/prefetch.py``) puts them
on the card.

The JAX loaders book the consumer's wait in ``next()`` to the goodput
ledger; the port has no ledger yet (ROADMAP A12), so these make no
ledger call.
"""

import numpy as np
import torch


class RepeatingLoader:
    """Wrap an iterable to restart on StopIteration (reference :10).

    On wrap-around the wrapped loader's epoch is advanced first (through
    ``set_epoch`` where it has one), so a shuffling
    ``DeepSpeedDataLoader`` draws a new permutation each epoch."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)
        # continue from the wrapped loader's own epoch (a resumed loader
        # must not restart the shuffle stream)
        self.epoch = int(getattr(loader, "epoch", 0))
        # batches already yielded from the current epoch: with the epoch
        # it pins the position in the (epoch-seeded) stream
        self.batch_in_epoch = 0

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.epoch += 1
            self.batch_in_epoch = 0
            set_epoch = getattr(self.loader, "set_epoch", None)
            if set_epoch is not None:
                set_epoch(self.epoch)
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        self.batch_in_epoch += 1
        return batch

    def state_dict(self):
        """The (epoch, offset) pair that pins the stream's position
        (``engine.save_checkpoint(..., data_iter=loader)`` saves it)."""
        return {"epoch": int(self.epoch),
                "batch_in_epoch": int(self.batch_in_epoch)}

    def load_state_dict(self, sd):
        """Move the stream to ``sd``'s position: the shuffle at the saved
        epoch, then the consumed batches skipped. A loader with
        ``set_resume`` (``DeepSpeedDataLoader``, ``PrefetchLoader``) skips
        inside its index plan and fetches nothing; another iterator is
        pulled and the batches dropped."""
        epoch = int(sd.get("epoch", 0))
        offset = int(sd.get("batch_in_epoch", 0))
        self.epoch = epoch
        set_epoch = getattr(self.loader, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
        set_resume = getattr(self.loader, "set_resume", None)
        close = getattr(self.data_iter, "close", None)
        if close is not None:
            # the old epoch's pipeline (a PrefetchIterator) stops now
            close()
        if set_resume is not None:
            set_resume(offset)
            self.data_iter = iter(self.loader)
        else:
            self.data_iter = iter(self.loader)
            for _ in range(offset):
                next(self.data_iter)
        self.batch_in_epoch = offset


class DeepSpeedDataLoader:
    """Batched, optionally shuffled, epoch-aware loader over an indexable
    dataset of tuples, dicts or arrays; built by ``engine.deepspeed_io``
    (reference engine.py:1474)."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 drop_last=True, collate_fn=None, num_local_io_workers=None,
                 data_sampler=None, process_index=0, process_count=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.data_sampler = data_sampler
        # the prefetch host stage's worker count (runtime/prefetch.py)
        self.num_local_io_workers = num_local_io_workers
        # one-shot mid-epoch resume offset (set_resume)
        self._resume_batches = 0
        n = len(dataset)
        per_proc = n // process_count if drop_last else -(-n // process_count)
        if drop_last:
            self.len = per_proc // batch_size
        else:
            self.len = -(-per_proc // batch_size)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def set_resume(self, batch_in_epoch):
        """Skip the first ``batch_in_epoch`` batches of the next iteration
        (one-shot). The epoch's plan is a function of (seed, epoch), so
        dropping its first slices gives the preempted run's remaining
        stream, and the skipped batches are never fetched."""
        self._resume_batches = max(0, int(batch_in_epoch))

    def __len__(self):
        return self.len

    def __iter__(self):
        return self._iter_batches()

    def _index_plan(self):
        """This epoch's batch index slices, in order. Split from
        :meth:`materialize` so the prefetch host stage can fetch and
        collate on several workers while one filler keeps the order."""
        n = len(self.dataset)
        if self.data_sampler is not None:
            # a user sampler already yields this rank's indices
            order = np.fromiter(iter(self.data_sampler), dtype=np.int64)
        else:
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch)
                order = rng.permutation(n)
            else:
                order = np.arange(n)
            order = order[self.process_index::self.process_count]
        skip, self._resume_batches = self._resume_batches, 0
        limit = self.len * self.batch_size
        for bnum, start in enumerate(
                range(0, min(len(order), limit), self.batch_size)):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            if bnum < skip:       # mid-epoch resume: already consumed
                continue
            yield idx

    def materialize(self, idx):
        """Fetch and collate one batch by its index slice (the prefetch
        workers call this off the consumer's thread)."""
        return self.collate_fn([self.dataset[int(i)] for i in idx])

    def _iter_batches(self):
        for idx in self._index_plan():
            yield self.materialize(idx)


def _stack(values):
    if isinstance(values[0], torch.Tensor):
        return torch.stack([v.cpu() for v in values])
    return torch.from_numpy(np.stack([np.asarray(v) for v in values]))


def _default_collate(samples):
    """Stack a list of samples into batched CPU tensors: a dict of
    stacks, a tuple of stacks, or one stack (JAX's, in torch)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_stack([s[i] for s in samples])
                     for i in range(len(first)))
    return _stack(samples)
