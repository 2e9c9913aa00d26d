"""The async IO engine of NVMe swapping (``aio_handle.py``)."""
