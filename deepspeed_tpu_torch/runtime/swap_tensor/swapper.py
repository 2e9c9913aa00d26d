"""Tensor <-> NVMe swapping (counterpart of
``deepspeed_tpu/runtime/swap_tensor/swapper.py``'s ``AsyncTensorSwapper``).

The reference's ``AsyncTensorSwapper`` (``swap_tensor/async_swapper.py``)
over the async IO engine (``ops/aio/aio_handle.py``): each key maps to
one file of the swap folder. ``swap_out`` submits an async write and
keeps the tensor alive until :meth:`AsyncTensorSwapper.synchronize`;
``swap_in`` reads a key back into a fresh CPU tensor; ``swap_in_async``
submits the read and returns the buffer with its request, the half of
the reference's pipelined optimizer swapper that overlaps the next read
with the current update.
"""

import os

import torch

from deepspeed_tpu_torch.ops.aio.aio_handle import AsyncIOHandle


class AsyncTensorSwapper:
    """Swap contiguous CPU tensors to files under ``swap_folder``."""

    def __init__(self, swap_folder, aio_handle=None):
        self.swap_folder = swap_folder
        os.makedirs(swap_folder, exist_ok=True)
        self.aio = aio_handle or AsyncIOHandle()
        self._pending = []
        self._meta = {}

    def _path(self, key):
        safe = key.replace("/", "_").replace("[", "_").replace("]", "_")
        return os.path.join(self.swap_folder, f"{safe}.swp")

    def swap_out(self, key, tensor, block=False):
        """Submit the write of ``tensor`` under ``key``; the tensor is kept
        alive until the write is waited for."""
        t = tensor.detach()
        if not t.is_contiguous():
            t = t.contiguous()
        self._meta[key] = {"shape": tuple(t.shape), "dtype": t.dtype,
                           "buf": t}
        self._pending.append(self.aio.async_pwrite(t, self._path(key)))
        if block:
            self.synchronize()

    def swap_in(self, key, block=True):
        """``key``'s tensor read back into a new CPU tensor (with ``block``
        False the read is only submitted: :meth:`synchronize` waits)."""
        meta = self._meta[key]
        out = torch.empty(meta["shape"], dtype=meta["dtype"])
        req = self.aio.async_pread(out, self._path(key))
        if block:
            self.wait(req, out.numel() * out.element_size())
        else:
            self._pending.append(req)
        return out

    def swap_in_async(self, key):
        """Submit a read of ``key``; returns ``(buffer, request)`` for
        :meth:`wait` just before the buffer is used."""
        meta = self._meta[key]
        out = torch.empty(meta["shape"], dtype=meta["dtype"])
        return out, self.aio.async_pread(out, self._path(key))

    def wait(self, req, expect_nbytes=None):
        """Block on one request; a failed or short transfer raises (the
        buffer would hold garbage)."""
        n = self.aio.wait(req)
        if n < 0:
            raise OSError(-n, "aio request failed")
        if expect_nbytes is not None and n != expect_nbytes:
            raise OSError(0, f"short aio transfer: {n} of {expect_nbytes} "
                             f"bytes")
        return n

    def synchronize(self):
        """Wait for every request in flight and release the tensors kept
        alive for the writes."""
        pending, self._pending = self._pending, []
        for req in pending:
            self.wait(req)
        for meta in self._meta.values():
            meta.pop("buf", None)
