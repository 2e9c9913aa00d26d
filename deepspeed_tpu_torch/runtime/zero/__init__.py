"""ZeRO for the PyTorch port over ``torch.distributed``: the config block
(``config.py``), the partition of stages 1-3 (``partition.py``), the
optimizer offload (``offload.py``) and ``TiledLinear`` (``tiling.py``)."""
