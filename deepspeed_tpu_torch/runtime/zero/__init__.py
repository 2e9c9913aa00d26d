"""ZeRO for the PyTorch port over ``torch.distributed``: the config block
(``config.py``), the partition of stages 1-3 (``partition.py``), the
optimizer offload (``offload.py``), parameter offload, the layered engine
(``param_offload.py``), the per-rank state footprint (``aot_check.py``)
and ``TiledLinear`` (``tiling.py``)."""
