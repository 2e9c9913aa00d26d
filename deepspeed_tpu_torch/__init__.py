"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

This package ports these paths, with hand-written CUDA kernels
(``csrc/``):

* cached GPT-2 generation: ``init_inference`` ->
  ``InferenceEngine.generate``, on the flash-attention forward and KV-cache
  decode-attention kernels;
* GPT-2 training: ``initialize`` -> ``DeepSpeedEngine`` (the loop users
  write, ``forward`` / ``backward`` / ``step``, and ``train_batch`` over
  it; ``eval_batch``; bf16, fp16 or fp32 compute over fp32 masters,
  Adam/AdamW, LAMB, SGD, Adagrad or a client optimizer, ZeRO stages 0-3;
  dropout keyed by (seed, micro-step) and remat), on the
  flash-attention forward and backward kernels and the fused Adam
  kernel;
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
* checkpoints: ``DeepSpeedEngine.save_checkpoint`` / ``load_checkpoint``
  / ``save_16bit_model`` in the JAX package's tag format (a tag written
  by either engine loads into the other), with the background persist of
  ``checkpoint.async_save``, ``utils.zero_to_fp32`` and
  ``init_inference(checkpoint=)``; a resumed run is bit-equal to an
  uninterrupted one on the training kernels;
* data parallelism over ``torch.distributed`` (``init_distributed``,
  ``utils.groups``): gradients averaged over the world, ZeRO-1's
  optimizer-state slices (``runtime.zero.partition``) and their
  all-gather, per-rank checkpoint shard files with tag validation, and
  ring and Ulysses attention (``ops.transformer.ring``) on the flash
  kernels' lse gradient;
* MoE-GPT (``moe``, ``comm.all_to_all``): top-1/top-2 gating over the
  global batch, the scatter, einsum and grouped dispatch, expert
  parallelism at any ``ep_size`` that divides the world
  (``utils.groups.initialize(ep_size=)``), training through the same
  entry point on the flash and Adam kernels, the per-expert checkpoint
  files, and ``init_inference(moe=True)`` on the flash and decode
  kernels;
* the data path: ``initialize(training_data=)`` and
  ``DeepSpeedEngine.deepspeed_io`` build a ``DeepSpeedDataLoader``
  (``RepeatingLoader`` around it, with its resume state in checkpoints),
  the ``data_prefetch`` pipeline (host collate workers and a
  copy-stream device stage, ``runtime.prefetch``), curriculum learning
  and progressive layer drop;
* ZeRO-3 parameter offload: ``initialize`` on a layered model
  (``models.gpt2.gpt2_offload_layers``) with
  ``zero_optimization.offload_param`` streams the layers from host RAM or
  NVMe one at a time on the flash kernels, the host CPU-Adam updating
  the masters (``runtime.zero.param_offload``);
* continuous-batching serving: ``init_serving`` -> ``ServingEngine``
  (``submit`` / ``step`` / ``collect`` / ``serve_forever``) over a paged
  KV cache, with chunked prefill, preemption, the prefix cache and
  speculative decoding; its ``gather`` impl runs the decode kernel, in
  one CUDA graph a decode step (``serving``).

It imports torch and numpy only; the JAX package ``deepspeed_tpu`` stays
the reference and is never imported from here.
"""

import os

import torch

from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.utils.logging import logger

__version__ = "0.1.0"


def init_inference(model, params=None, dtype=None, device=None,
                   checkpoint=None, **kwargs):
    """Create an inference engine (reference: deepspeed.init_inference).

    ``device=None`` means CUDA and raises when no card is present;
    ``dtype`` defaults to bfloat16; ``torch.int8`` stores the transformer
    weights in int8 under bf16 activations. ``checkpoint`` is a
    ``mp_rank_00_model_states.pt`` written by either engine, or a
    ``save_16bit_model`` file, loaded when ``params`` is not given."""
    return InferenceEngine(model, params=params, dtype=dtype, device=device,
                           checkpoint=checkpoint, **kwargs)


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


def init_distributed(dist_backend=None, verbose=True, init_method=None,
                     world_size=None, rank=None):
    """Initialise ``torch.distributed`` (reference:
    deepspeed.init_distributed; JAX ``__init__.py:32``). Safe to call
    again once initialised.

    ``dist_backend`` defaults to ``nccl``, which needs a card (it raises
    without one); ``"gloo"`` runs on the CPU. The world size and rank come
    from the arguments, else from a launcher's ``WORLD_SIZE`` / ``RANK``,
    else 1 and 0. The rendezvous is ``init_method``, else ``env://`` when
    ``MASTER_ADDR`` is set, else (one rank) an in-process store. Any
    world size is valid: the engine averages the gradients over it and
    shards the optimizer state at ZeRO stage 1 (``utils.groups``: the
    data-parallel group is the world). One process drives one card; on
    CUDA the rank's device is ``cuda:<LOCAL_RANK>`` (default the rank),
    set here as NCCL needs it."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    if dist_backend is None:
        resolve_device(None)        # nccl needs the card
        dist_backend = "nccl"
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    elif os.environ.get("MASTER_ADDR") is not None:
        kw["init_method"] = "env://"
    elif world_size == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError("init_distributed: a world of more than one rank "
                         "needs init_method= or MASTER_ADDR/MASTER_PORT")
    if dist_backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(dist_backend, world_size=world_size, rank=rank,
                            **kw)
    if verbose:
        logger.info("initialised torch.distributed: backend %s, rank %d "
                    "of %d", dist_backend, rank, world_size)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, collate_fn=None,
               config=None, config_params=None, device=None, seed=42,
               **kwargs):
    """Create a training engine (reference: deepspeed.initialize).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``,
    the tuple contract of the JAX ``initialize``. ``model`` is a port
    ``nn.Module`` whose ``forward(batch)`` returns the loss; its
    parameters become the
    fp32 masters on ``device`` (``None`` means CUDA, and raises without a
    card). ``model_parameters``, when given, is a state_dict loaded into
    it (for example ``bridge.flax_to_state_dict`` or
    ``bridge.bert_flax_to_state_dict`` of flax params); at an
    expert-parallel size above 1 each rank keeps its experts of a
    whole-layer expert leaf. The config is
    ``config``, else ``config_params``, else ``args.deepspeed_config`` (a
    dict or a JSON path). ``optimizer`` is a client
    ``runtime.optim.Optimizer(init, update)`` pair (anything else raises,
    a ``torch.optim`` optimizer too), ``lr_scheduler`` a client schedule
    (``runtime.lr_schedules``), ``seed`` the dropout seed (JAX default
    42). The data-parallel world (``utils.groups``) goes to the config,
    as in JAX (engine.py:281-294); a pre-built ``DeepSpeedConfig`` whose
    ``world_size`` differs raises (in the engine, which owns the group).
    Each rank passes its own micro-batches to the engine.

    ``training_data`` is an indexable dataset (``len`` and ``[i]``): the
    engine's ``deepspeed_io`` wraps it into the returned loader, this
    rank's micro-batches collated by ``collate_fn`` (default: stacked
    into CPU tensors), behind the ``data_prefetch`` pipeline when that
    block is on; feed it as ``train_batch(data_iter=RepeatingLoader(
    loader))``. It is None without ``training_data``.

    ZeRO-3 parameter offload (``zero_optimization.offload_param.device``
    cpu or nvme, or the deprecated ``cpu_offload_params: true`` at stage
    3) takes the layered engine, as in JAX (``__init__.py:84-155``):
    ``model`` is a sequence of layers (``models.gpt2
    .gpt2_offload_layers``), ``sample_batch=`` is required and
    ``input_fn=`` takes the first layer's input from a batch; it returns
    ``(runtime.zero.param_offload.Zero3OffloadEngine, None, None,
    None)``, and refuses ``training_data`` as JAX's does. Not ported
    yet: the other keywords of the JAX ``initialize`` (``mpu``, ...)."""
    cfg_dict = _config_dict(config if config is not None else config_params)
    from deepspeed_tpu_torch.runtime.zero.config import param_offload_device
    offload = param_offload_device(cfg_dict)
    if offload is not None:
        return _initialize_param_offload(
            model, optimizer, lr_scheduler, training_data, cfg_dict,
            offload, device, kwargs)
    for key, value in kwargs.items():
        if value is not None:
            raise NotImplementedError(
                f"initialize({key}=...) is not ported yet")
    if model is None:
        raise ValueError("initialize needs model=")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("initialize needs config= (a dict or a JSON path) "
                         "or args.deepspeed_config")
    from deepspeed_tpu_torch.utils import groups
    if not groups.mesh_is_initialized():
        groups.initialize()
    cfg = config
    if not isinstance(cfg, DeepSpeedConfig):
        cfg = DeepSpeedConfig(
            cfg, data_parallel_size=groups.get_data_parallel_world_size())
    dev = resolve_device(device)
    model = model.to(dev)
    if model_parameters is not None:
        from deepspeed_tpu_torch.moe.layer import localize_state_dict
        model.load_state_dict(localize_state_dict(model_parameters, model))
    engine = DeepSpeedEngine(model, cfg, dev, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, seed=seed,
                             training_data=training_data,
                             collate_fn=collate_fn)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def _config_dict(config):
    """The raw config dict of ``config`` (a dict, a JSON path or a
    ``DeepSpeedConfig``), or None."""
    if isinstance(config, DeepSpeedConfig):
        return config._param_dict
    if isinstance(config, str) and os.path.exists(config):
        import json
        with open(config) as f:
            return json.load(f)
    return config if isinstance(config, dict) else None


def _initialize_param_offload(model, optimizer, lr_scheduler, training_data,
                              cfg, device_kind, device, kwargs):
    """JAX ``initialize``'s parameter-offload branch: its refusals, with
    the exception classes its tests expect, then the layered engine."""
    import torch
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
    from deepspeed_tpu_torch.runtime.zero.param_offload import \
        Zero3OffloadEngine
    if not isinstance(model, (list, tuple)):
        raise AssertionError(
            "offload_param requires a layered model: pass model as a "
            "sequence of torch modules (body layers x->x, final layer "
            "(x, batch)->loss), e.g. models.gpt2.gpt2_offload_layers(cfg)")
    if "sample_batch" not in kwargs:
        raise AssertionError("offload_param requires sample_batch= for "
                             "shape init")
    if optimizer is not None or lr_scheduler is not None or \
            training_data is not None:
        raise AssertionError(
            "offload_param drives its own host CPU-Adam; client "
            "optimizer/lr_scheduler/training_data are unsupported")
    unknown = set(kwargs) - {"sample_batch", "input_fn"}
    if unknown:
        raise NotImplementedError(
            f"initialize({', '.join(sorted(unknown))}=...) is not ported "
            f"yet")
    opt_cfg = cfg.get("optimizer", {}) or {}
    if str(opt_cfg.get("type", "Adam")).lower() not in ("adam", "adamw"):
        raise AssertionError(
            f"offload_param drives the host CPU-Adam; optimizer type "
            f"{opt_cfg.get('type')!r} is unsupported on this path")
    off = (cfg.get("zero_optimization") or {}).get("offload_param") or {}
    if device_kind == "nvme" and not off.get("nvme_path"):
        raise AssertionError("offload_param.device='nvme' requires "
                             "nvme_path")
    unsupported = []
    if (cfg.get("scheduler", {}) or {}).get("type"):
        unsupported.append("scheduler")
    if cfg.get("gradient_clipping", 0):
        unsupported.append("gradient_clipping")
    if (cfg.get("fp16", {}) or {}).get("enabled"):
        unsupported.append("fp16 dynamic loss scaling (bf16 is supported)")
    if cfg.get("sparse_gradients"):
        unsupported.append("sparse_gradients")
    if unsupported:
        raise DeepSpeedConfigError(
            "the layered Zero3OffloadEngine does not implement: "
            + ", ".join(unsupported)
            + "; remove these keys or use the monolithic engine "
            "(offload_optimizer instead of offload_param)")
    from deepspeed_tpu_torch.utils import groups
    world = groups.get_data_parallel_world_size()
    if world > 1:
        raise NotImplementedError(
            f"offload_param at a data-parallel world of {world} ranks: the "
            f"layered Zero3OffloadEngine trains one rank (JAX's "
            f"param_offload.py scope) and would not average the ranks' "
            f"gradients; data parallelism runs through the monolithic "
            f"engine (offload_optimizer)")
    params = opt_cfg.get("params", {}) or {}
    dtype = (torch.bfloat16 if (cfg.get("bf16", {}) or {}).get("enabled")
             else torch.float32)
    engine = Zero3OffloadEngine(
        model, kwargs["sample_batch"], lr=params.get("lr", 1e-3),
        betas=tuple(params.get("betas", (0.9, 0.999))),
        eps=params.get("eps", 1e-8),
        weight_decay=params.get("weight_decay", 0.0),
        nvme_path=off.get("nvme_path") if device_kind == "nvme" else None,
        compute_dtype=dtype, input_fn=kwargs.get("input_fn"), device=device)
    return engine, None, None, None


def add_config_arguments(parser):
    """Add the DeepSpeed argument group to an ``argparse`` parser
    (reference: deepspeed.add_config_arguments; the JAX package's
    ``__init__.py:272``, copied)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag to ease "
                            "transition)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated enable flag")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated config path")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI")
    return parser


# public module alias (reference: deepspeed.checkpointing)
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing  # noqa: E402
# public subpackage (reference: deepspeed.zero)
from deepspeed_tpu_torch import zero  # noqa: E402

__all__ = ["DeepSpeedConfig", "DeepSpeedEngine", "InferenceEngine",
           "add_config_arguments", "checkpointing", "init_distributed", "zero",
           "init_inference", "init_serving", "initialize", "__version__"]
