"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

This package ports the cached-generation path
(``init_inference`` -> ``InferenceEngine.generate`` over GPT-2) with
hand-written CUDA kernels for flash-attention prefill and KV-cache decode
attention (``csrc/``). It imports torch and numpy only; the JAX package
``deepspeed_tpu`` stays the reference and is never imported from here.
"""

from deepspeed_tpu_torch.inference.engine import InferenceEngine

__version__ = "0.1.0"


def init_inference(model, params=None, dtype=None, device=None, **kwargs):
    """Create an inference engine (reference: deepspeed.init_inference).

    ``device=None`` means CUDA and raises when no card is present;
    ``dtype`` defaults to bfloat16."""
    return InferenceEngine(model, params=params, dtype=dtype, device=device,
                           **kwargs)


__all__ = ["InferenceEngine", "init_inference", "__version__"]
