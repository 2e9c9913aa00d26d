"""The async IO engine's Python surface (counterpart of
``deepspeed_tpu/ops/aio/aio_handle.py``).

The reference binding's ``aio_handle`` (``csrc/aio/py_ds_aio.cpp:12``:
block_size, queue_depth, single_submit, overlap_events, thread_count;
sync and async pread/pwrite) over the C interface of ``csrc/aio.cpp``,
built by ``ops/op_builder.load_host``. Buffers are contiguous CPU
tensors, passed by ``data_ptr()``. Transfers run through Linux kernel AIO
over ``O_DIRECT`` where the file system takes it, else through the
engine's own thread pool of pread/pwrite (tmpfs and overlayfs refuse
``O_DIRECT``): :meth:`AsyncIOHandle.kernel_aio_available` says which.
"""

from deepspeed_tpu_torch.ops import op_builder


def _buf(t):
    """(pointer, bytes) of a contiguous CPU tensor."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"aio buffers are contiguous CPU tensors, got one "
                         f"on {t.device}")
    return t.data_ptr(), t.numel() * t.element_size()


class AsyncIOHandle:
    def __init__(self, block_size=1 << 20, queue_depth=8,
                 single_submit=False, overlap_events=True, thread_count=1):
        self.lib = op_builder.load_host("aio")
        self.handle = self.lib.aio_handle_create(
            block_size, queue_depth, int(single_submit), int(overlap_events),
            thread_count)
        if self.handle <= 0:
            raise RuntimeError("aio handle creation failed")
        self._block_size = block_size
        self._thread_count = thread_count

    # the reference's getters (deepspeed_py_aio_handle.cpp)
    def get_block_size(self):
        return self._block_size

    def get_thread_count(self):
        return self._thread_count

    def kernel_aio_available(self, probe_dir=None):
        """True when transfers (of files under ``probe_dir``) run through
        kernel ``io_submit``; False: the thread pool's pread/pwrite. Probes
        ``io_setup`` and an ``O_DIRECT`` open in ``probe_dir`` (None:
        ``io_setup`` only)."""
        d = probe_dir.encode() if probe_dir is not None else None
        return bool(self.lib.aio_kernel_available(d))

    def max_inflight(self):
        """The most kernel-AIO requests in flight at once since the last
        reset (0: the thread pool only)."""
        return int(self.lib.aio_max_inflight())

    def reset_max_inflight(self):
        self.lib.aio_reset_max_inflight()

    def sync_pread(self, buffer, path, offset=0):
        ptr, nbytes = _buf(buffer)
        n = self.lib.aio_sync_pread(self.handle, ptr, path.encode(), nbytes,
                                    offset)
        if n < 0:
            raise OSError(-n, f"pread of {path} failed")
        return n

    def sync_pwrite(self, buffer, path, offset=0):
        ptr, nbytes = _buf(buffer)
        n = self.lib.aio_sync_pwrite(self.handle, ptr, path.encode(), nbytes,
                                     offset)
        if n != nbytes:
            raise OSError(-n if n < 0 else 0, f"pwrite of {path} wrote {n} "
                          f"of {nbytes} bytes")
        return n

    def async_pread(self, buffer, path, offset=0):
        ptr, nbytes = _buf(buffer)
        req = self.lib.aio_async_pread(self.handle, ptr, path.encode(),
                                       nbytes, offset)
        if req <= 0:
            raise OSError(-req, f"async pread of {path} was not submitted")
        return req

    def async_pwrite(self, buffer, path, offset=0):
        ptr, nbytes = _buf(buffer)
        req = self.lib.aio_async_pwrite(self.handle, ptr, path.encode(),
                                        nbytes, offset)
        if req <= 0:
            raise OSError(-req, f"async pwrite of {path} was not submitted")
        return req

    def wait(self, request_id):
        """Block on one request; its byte count, or -errno."""
        return self.lib.aio_wait(self.handle, request_id)

    def __del__(self):
        try:
            self.lib.aio_handle_destroy(self.handle)
        except Exception:
            pass
