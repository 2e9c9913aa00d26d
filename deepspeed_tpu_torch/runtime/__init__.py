"""runtime of the PyTorch port: the training engine and what it runs on
(see deepspeed_tpu_torch/__init__.py)."""
