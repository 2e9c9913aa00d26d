"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

This package ports five paths, with hand-written CUDA kernels
(``csrc/``):

* cached GPT-2 generation: ``init_inference`` ->
  ``InferenceEngine.generate``, on the flash-attention forward and KV-cache
  decode-attention kernels;
* GPT-2 training: ``initialize`` -> ``DeepSpeedEngine.train_batch`` (bf16,
  fp16 or fp32 compute over fp32 masters, Adam/AdamW, ZeRO stage 0/1 on
  one rank), on the flash-attention forward and backward kernels and the
  fused Adam kernel;
* BERT MLM pretraining: the same entry point on
  ``models.bert.BertForPreTraining`` with LAMB, on the flash kernels
  (non-causal), the LayerNorm forward/backward and bias-GeLU kernels of
  the fused encoder layer, and the one-launch fused LAMB kernel;
* MoQ and int8 weights: the ``quantize_training`` config block
  fake-quantizes the fp32 masters after every applied step on the
  grouped-quantize kernel, and ``init_inference(dtype=torch.int8)``
  generates on int8 transformer weights with per-row scales. The scaled
  softmax kernel (``ops.transformer.fused.fused_softmax``) lies on no
  path, as in the JAX package;
* block-sparse attention: BERT with ``sparse_attention_mode`` and GPT-2
  with ``attention_mode="sparse..."`` train through the same entry point
  on the block-sparse forward, dq and dk/dv kernels
  (``ops.sparse_attention``);
* continuous-batching serving: ``init_serving`` -> ``ServingEngine``
  (``submit`` / ``step`` / ``collect`` / ``serve_forever``) over a paged
  KV cache, with chunked prefill, preemption, the prefix cache and
  speculative decoding; its ``gather`` impl runs the decode kernel, in
  one CUDA graph a decode step (``serving``).

It imports torch and numpy only; the JAX package ``deepspeed_tpu`` stays
the reference and is never imported from here.
"""

from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

__version__ = "0.1.0"


def init_inference(model, params=None, dtype=None, device=None, **kwargs):
    """Create an inference engine (reference: deepspeed.init_inference).

    ``device=None`` means CUDA and raises when no card is present;
    ``dtype`` defaults to bfloat16; ``torch.int8`` stores the transformer
    weights in int8 under bf16 activations."""
    return InferenceEngine(model, params=params, dtype=dtype, device=device,
                           **kwargs)


def init_serving(model=None, engine=None, params=None, checkpoint=None,
                 dtype=None, config=None, draft_params=None,
                 draft_scales=None, **kwargs):
    """Create a continuous-batching serving engine (serving/server.py;
    reference: ``deepspeed_tpu.init_serving``).

    Pass an existing ``InferenceEngine`` as ``engine``, or a model (and
    ``params``, a state_dict, and ``dtype``) and one is built through
    :func:`init_inference` (``device=None`` means CUDA and raises without
    a card). ``config`` is a ds-config dict whose ``serving`` block sizes
    the paged KV cache and the slot batch. ``draft_params`` is an explicit
    small draft model's state_dict for ``serving.speculative`` (omit it to
    self-draft from the target's first layers). The remaining keywords go
    to :func:`init_inference`."""
    if engine is None:
        if model is None:
            raise ValueError("init_serving needs a model or an engine")
        engine = init_inference(model, params=params, checkpoint=checkpoint,
                                dtype=dtype, **kwargs)
    from deepspeed_tpu_torch.serving.server import ServingEngine
    return ServingEngine(engine, config=config, draft_params=draft_params,
                         draft_scales=draft_scales)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, device=None, **kwargs):
    """Create a training engine (reference: deepspeed.initialize).

    Returns ``(engine, optimizer, None, lr_scheduler)``, the tuple
    contract of the JAX ``initialize``. ``model`` is a port ``nn.Module``
    whose ``forward(batch)`` returns the loss; its parameters become the
    fp32 masters on ``device`` (``None`` means CUDA, and raises without a
    card). ``model_parameters``, when given, is a state_dict loaded into
    it (for example ``bridge.flax_to_state_dict`` or
    ``bridge.bert_flax_to_state_dict`` of flax params).
    Not ported yet: ``training_data`` (the dataloader), a client
    ``optimizer`` or ``lr_scheduler``, and ``args`` carrying the
    config."""
    unported = {"training_data (the dataloader)": training_data,
                "a client optimizer": optimizer,
                "a client lr_scheduler": lr_scheduler,
                "args": args}
    unported.update({f"initialize({k}=...)": v for k, v in kwargs.items()})
    for what, value in unported.items():
        if value is not None:
            raise NotImplementedError(f"{what} is not ported yet")
    if model is None:
        raise ValueError("initialize needs model=")
    if config is None:
        config = config_params
    if config is None:
        raise ValueError("initialize needs config= (a dict or a JSON path)")
    cfg = DeepSpeedConfig(config)
    dev = resolve_device(device)
    model = model.to(dev)
    if model_parameters is not None:
        model.load_state_dict(model_parameters)
    engine = DeepSpeedEngine(model, cfg, dev)
    return engine, engine.optimizer, None, engine.lr_scheduler


__all__ = ["DeepSpeedConfig", "DeepSpeedEngine", "InferenceEngine",
           "init_inference", "init_serving", "initialize", "__version__"]
