"""ops/sparse_attention of the PyTorch port (see deepspeed_tpu_torch/__init__.py)."""
