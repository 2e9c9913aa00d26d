"""Device resolution and kernel selection.

Counterpart of ``deepspeed_tpu/ops/_platform.py``. Entry points take
``device=None``, which means the CUDA card; without one they raise rather
than run on the CPU unasked. A kernel wrapper picks its route from the
device of the tensors it is given and from nothing else: CUDA tensors
launch the hand-written kernel, CPU tensors run its plain PyTorch version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for (explicitly or
    by default) and no card is present; ``device="cpu"`` must be asked
    for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_kernel(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (run the plain version). Tensors on
    different devices raise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")
