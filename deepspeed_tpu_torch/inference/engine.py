"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

Casts the model's floating parameters to the serving dtype, places it on
the device, and generates. ``generate`` defaults to cached decoding: one
prefill forward writes the prompt's K/V into a :class:`KVCache`, then
each new token is one single-token forward, as a host loop (the JAX
package compiles the same loop into one ``lax.scan``).

``dtype=torch.int8`` (JAX engine.py:46-56, 95-120) keeps the floats in
bf16 and the transformer weights in int8: the floating parameters are
cast to bf16 first, then ``module_inject.quantize_transformer_layer``
swaps the matched weights for int8 with per-output-unit fp32 scales
beside them; ``int8_bytes_saved`` is the JAX counter
``inference_int8_bytes_saved_total``.

``checkpoint=`` (JAX engine.py:130-215, the model-states and 16-bit
forms) is a path to a ``mp_rank_00_model_states.pt`` written by either
engine, or to the file ``save_16bit_model`` writes. Its ``module`` tree
(a flax tree for a model family of ``bridge.LAYOUTS``, else the
``state_dict`` names) is loaded into the model before the ``dtype`` cast
or the int8 path; ``params`` wins when both are given, as in JAX.

MoE (JAX engine.py:42-80, 181-190): a MoE-GPT model, or a MoE tag whose
expert files (``layer_*_expert_*_model_states.pt``) are stacked back
into the ``module`` tree, generates through the same cached loop, on the
flash (prefill) and decode kernels; its MoE blocks gate each call's
tokens with the eval capacity factor. ``moe``, ``moe_experts`` and
``moe_type`` are kept as JAX keeps them (the expert tables carry their
own count). ``ep_size > 1`` raises: this engine has no process group
(ROADMAP Queue A, MoE's rest).

A module without the ``cache`` protocol (GPT-J, ``models/gptj.py``, as
JAX's GPT-J has no cache either) generates by recompute: a full
forward with ``return_logits=True`` a token.

Not ported yet: tensor parallelism (``mp_size > 1``), expert parallelism
at inference, the Megatron checkpoint description JSON
(``runtime/state_dict_factory.py``), the HF/Megatron naming conversions
(the ``module_inject`` policies),
``quantization_setting`` (``runtime/weight_quantizer.py``) and a custom
``apply_fn``.
"""

import inspect
import os
import zipfile

import numpy as np
import torch

from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.runtime.checkpoint_io import load_file, module_tree
from deepspeed_tpu_torch.telemetry.metrics import get_registry
from deepspeed_tpu_torch.telemetry.tracer import trace_span


def _param_bytes(module):
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def load_checkpoint_state_dict(path, model):
    """``model``'s state_dict from a checkpoint file: a model-states
    pickle of either engine (its ``module`` tree) or a ``torch.save``
    state dict (``save_16bit_model``). A flax tree goes through the
    layout table of ``model``'s family."""
    path = str(path)
    if path.endswith(".json"):
        raise NotImplementedError(
            "the Megatron checkpoint description JSON (SDLoaderFactory, "
            "runtime/state_dict_factory.py) is not ported yet")
    if zipfile.is_zipfile(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        sd = load_file(path, kind="model_states")
    if isinstance(sd, dict) and "module" in sd:
        sd = module_tree(sd, path)
    names = list(model.state_dict())
    if isinstance(sd, dict) and all(n in sd for n in names):
        return {n: _tensor(sd[n]) for n in names}
    table = bridge.layout_of(dict(model.named_parameters()))
    if isinstance(sd, dict) and table is not None and \
            set(table) == set(names):
        try:
            return {n: _tensor(x)
                    for n, x in bridge.from_flax(table, sd).items()}
        except KeyError:
            pass
    raise NotImplementedError(
        f"{os.path.basename(path)}: its names match neither the model's "
        f"state_dict nor the model family's flax tree; the HF/Megatron "
        f"naming conversions (module_inject policies, "
        f"state_dict_factory) are not ported yet")


class InferenceEngine:
    def __init__(self, model, params=None, dtype=None, device=None,
                 mp_size=1, checkpoint=None, moe=False, ep_size=1,
                 moe_experts=1, moe_type="standard",
                 quantization_setting=None, apply_fn=None):
        """``params``: an optional state_dict loaded into ``model`` (e.g.
        from :func:`deepspeed_tpu_torch.bridge.flax_to_state_dict`);
        ``checkpoint``: a checkpoint file to load when ``params`` is not
        given (:func:`load_checkpoint_state_dict`).
        ``dtype`` (default bfloat16) is the dtype of the floating
        parameters and activations, or ``torch.int8`` for int8
        transformer weights under bf16 activations; ``device=None`` means
        CUDA."""
        self._int8_weights = dtype == torch.int8
        if self._int8_weights and apply_fn is not None:
            raise ValueError(
                "dtype=int8 quantizes the weights and keeps their scales in "
                "buffers the model's forward reads; a custom apply_fn would "
                "bypass it — drop apply_fn or quantize explicitly via "
                "module_inject.quantize_transformer_layer")
        for what, hit in (("mp_size > 1", mp_size > 1),
                          ("ep_size > 1 (expert parallelism at inference)",
                           ep_size > 1),
                          ("quantization_setting (the MoQ weight quantizer "
                           "of checkpoint loading, "
                           "runtime/weight_quantizer.py)",
                           quantization_setting is not None),
                          ("a custom apply_fn", apply_fn is not None)):
            if hit:
                raise NotImplementedError(f"{what} is not ported yet")
        self.moe = bool(moe)
        self.ep_size, self.moe_experts = ep_size, moe_experts
        self.moe_type = moe_type
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if self._int8_weights or dtype is None \
            else dtype
        if params is None and checkpoint is not None:
            with trace_span("inference_checkpoint_load",
                            path=str(checkpoint)):
                params = load_checkpoint_state_dict(checkpoint, model)
            get_registry().counter(
                "inference_checkpoint_bytes_total",
                "param bytes materialised by inference checkpoint loads"
            ).inc(sum(t.numel() * t.element_size()
                      for t in params.values()))
        if params is not None:
            model.load_state_dict(params)
        self.module = model.to(device=self.device, dtype=self.dtype).eval()
        self.quant_scales = None
        self.int8_bytes_saved = 0
        if self._int8_weights:
            from deepspeed_tpu_torch.module_inject.module_quantize import \
                quantize_transformer_layer
            before = _param_bytes(self.module)
            self.quant_scales = quantize_transformer_layer(self.module)
            scale_bytes = sum(s.numel() * s.element_size()
                              for s in self.quant_scales.values())
            self.int8_bytes_saved = max(
                0, before - _param_bytes(self.module) - scale_bytes)

    def _call_params(self):
        try:
            return inspect.signature(type(self.module).forward).parameters
        except (TypeError, ValueError):
            return {}

    def _supports_kv_cache(self) -> bool:
        """True when the module takes a ``cache`` (the :class:`KVCache`
        protocol of models/gpt2.py) and can make one."""
        return ("cache" in self._call_params()
                and hasattr(self.module, "new_cache"))

    @torch.no_grad()
    def forward(self, batch, **kwargs):
        return self.module(batch, **kwargs)

    __call__ = forward

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 logits_fn=None, generator=None, eos_token_id=None,
                 use_cache=None):
        """Greedy (``temperature=0``) or sampled decoding; returns the
        prompt followed by ``max_new_tokens`` tokens, [B, S + new].

        Cached decoding is the default; a custom ``logits_fn(ids) ->
        [B, S, V]`` or a module without cache support recomputes the
        whole sequence per token. ``generator`` (a ``torch.Generator`` on
        the engine's device) drives sampling. With ``eos_token_id`` a
        sequence that produced it keeps producing it."""
        input_ids = torch.as_tensor(input_ids, device=self.device).long()
        if use_cache is None:
            use_cache = logits_fn is None and self._supports_kv_cache()
        if use_cache:
            return self._generate_cached(input_ids, max_new_tokens,
                                         float(temperature), generator,
                                         eos_token_id)
        return self._generate_recompute(input_ids, max_new_tokens,
                                        float(temperature), logits_fn,
                                        generator, eos_token_id)

    def _sample(self, last, generator, temperature):
        # padded vocab rows exist only for alignment: never sample them
        vs = getattr(getattr(self.module, "config", None), "vocab_size", None)
        if vs is not None and vs < last.shape[-1]:
            last = last[..., :vs]
        if temperature > 0:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(last, dim=-1)

    def _generate_cached(self, input_ids, max_new_tokens, temperature,
                         generator, eos_token_id):
        B, S = input_ids.shape
        max_pos = getattr(getattr(self.module, "config", None),
                          "n_positions", None)
        if max_pos is not None and S + max_new_tokens > max_pos:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the model's n_positions ({max_pos})")
        cache = self.module.new_cache(B)
        logits = self.module({"input_ids": input_ids}, cache=cache,
                             last_only=True)
        tok = self._sample(logits[:, -1], generator, temperature)
        out = [tok]
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        for _ in range(max_new_tokens - 1):
            logits = self.module({"input_ids": tok[:, None]}, cache=cache,
                                 last_only=True)
            nxt = self._sample(logits[:, -1], generator, temperature)
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
                nxt = torch.where(done, eos_token_id, nxt)
            tok = nxt
            out.append(tok)
        return torch.cat([input_ids, torch.stack(out, dim=1)], dim=1)

    def _generate_recompute(self, input_ids, max_new_tokens, temperature,
                            logits_fn, generator, eos_token_id):
        if logits_fn is None:
            def logits_fn(ids):
                return self.module({"input_ids": ids}, return_logits=True)
        B, S = input_ids.shape
        ids = input_ids
        for t in range(S, S + max_new_tokens):
            nxt = self._sample(logits_fn(ids)[:, -1], generator, temperature)
            if eos_token_id is not None and t > S:
                nxt = torch.where(ids[:, -1] == eos_token_id, eos_token_id,
                                  nxt)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
        return ids
