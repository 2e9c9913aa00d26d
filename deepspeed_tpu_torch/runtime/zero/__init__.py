"""ZeRO for the PyTorch port: stage 1 over ``torch.distributed``
(``partition.py``); stages 2 and 3 are not ported yet."""
