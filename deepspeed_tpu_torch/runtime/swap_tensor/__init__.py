"""Tensor swapping to NVMe over the async IO engine (``swapper.py``)."""
