"""Flax GPT-2 and BERT parameters -> the port's ``state_dict``.

:func:`flax_to_state_dict` takes the params pytree of
``deepspeed_tpu.models.gpt2.GPT2LMHeadModel`` as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the state_dict
of ``deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel``;
:func:`bert_flax_to_state_dict` does the same for ``BertForPreTraining``.
Dense kernels go
from flax's ``[in, out]`` to ``[out, in]`` (the fused QKV keeps its
``[q | k | v]`` column order as row order), LayerNorm ``scale``/``bias``
become ``weight``/``bias``, flax block ``h_{i}`` becomes ``h.{i}``, and
``wte`` keeps its padded vocab (it is also the tied LM head).
:func:`simple_flax_to_state_dict` and :func:`cifar_flax_to_state_dict`
carry the fixture models (``models/simple.py``) and the CIFAR net
(``models/cifar.py``). This module imports neither jax nor flax.
"""

import numpy as np
import torch


def _leaf(x):
    return torch.from_numpy(np.array(x, copy=True))


def _dense(tree, prefix, out):
    out[f"{prefix}.weight"] = _leaf(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _leaf(tree["bias"])


def _norm(tree, prefix, out):
    out[f"{prefix}.weight"] = _leaf(tree["scale"])
    out[f"{prefix}.bias"] = _leaf(tree["bias"])


def flax_to_state_dict(params) -> dict:
    """Convert a flax GPT-2 params tree (numpy leaves) to a state_dict."""
    if "params" in params:
        params = params["params"]
    sd = {"wte": _leaf(params["wte"]), "wpe": _leaf(params["wpe"])}
    n_layer = sum(1 for name in params if name.startswith("h_"))
    for i in range(n_layer):
        blk = params[f"h_{i}"]
        p = f"h.{i}"
        _norm(blk["ln_1"], f"{p}.ln_1", sd)
        _norm(blk["ln_2"], f"{p}.ln_2", sd)
        _dense(blk["attn"]["qkv"], f"{p}.attn.qkv", sd)
        _dense(blk["attn"]["proj"], f"{p}.attn.proj", sd)
        _dense(blk["mlp"]["fc"], f"{p}.mlp.fc", sd)
        _dense(blk["mlp"]["proj"], f"{p}.mlp.proj", sd)
    _norm(params["ln_f"], "ln_f", sd)
    return sd


def bert_flax_to_state_dict(params) -> dict:
    """Convert a flax BERT params tree (numpy leaves) to the state_dict of
    ``deepspeed_tpu_torch.models.bert.BertForPreTraining``. Dense kernels
    are transposed to ``[out, in]`` and LayerNorm ``scale`` becomes
    ``weight``; the raw params (embeddings, ``mlm_bias``, the fused
    layer's ``inter_w`` [in, out], ``inter_b`` and LayerNorm
    ``*_gamma``/``*_beta``) are carried across as they are. Flax layer
    ``layer_{i}`` becomes ``layer.{i}``; a sparse layer's ``attention/qkv``,
    ``attn_out``, ``fc`` and ``out`` denses and ``attn_ln``/``out_ln``
    LayerNorms keep their names."""
    if "params" in params:
        params = params["params"]
    sd = {k: _leaf(params[k]) for k in (
        "word_embeddings", "position_embeddings", "token_type_embeddings",
        "mlm_bias")}
    _norm(params["emb_ln"], "emb_ln", sd)
    n_layer = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layer):
        if "attention" in params[f"layer_{i}"]:
            # BertSparseLayer: flax denses and LayerNorms
            lay = params[f"layer_{i}"]
            p = f"layer.{i}"
            _dense(lay["attention"]["qkv"], f"{p}.attention.qkv", sd)
            for dense in ("attn_out", "fc", "out"):
                _dense(lay[dense], f"{p}.{dense}", sd)
            for norm in ("attn_ln", "out_ln"):
                _norm(lay[norm], f"{p}.{norm}", sd)
            continue
        lay = params[f"layer_{i}"]["layer"]
        p = f"layer.{i}.layer"
        for raw in ("attn_ln_gamma", "attn_ln_beta", "ln_gamma", "ln_beta",
                    "inter_w", "inter_b"):
            sd[f"{p}.{raw}"] = _leaf(lay[raw])
        for dense in ("attn_qkv", "attn_out", "output_w"):
            _dense(lay[dense], f"{p}.{dense}", sd)
    _dense(params["mlm_dense"], "mlm_dense", sd)
    _norm(params["mlm_ln"], "mlm_ln", sd)
    return sd


def simple_flax_to_state_dict(params) -> dict:
    """Convert the flax params of ``SimpleModel`` or ``LinearStack``
    (denses ``Dense_{i}``) or ``EmbeddingModel`` (``wte`` and
    ``Dense_0``) to the port model's state_dict: ``layers.{i}``, or
    ``wte`` and ``dense``."""
    if "params" in params:
        params = params["params"]
    sd = {}
    if "wte" in params:
        sd["wte.weight"] = _leaf(params["wte"]["embedding"])
        _dense(params["Dense_0"], "dense", sd)
        return sd
    n = sum(1 for name in params if name.startswith("Dense_"))
    for i in range(n):
        _dense(params[f"Dense_{i}"], f"layers.{i}", sd)
    return sd


def cifar_flax_to_state_dict(params) -> dict:
    """Convert the flax ``CifarNet`` params to the port net's state_dict:
    conv kernels from ``[kh, kw, in, out]`` to ``[out, in, kh, kw]``,
    dense kernels transposed."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for conv in ("conv1", "conv2"):
        sd[f"{conv}.weight"] = _leaf(
            np.asarray(params[conv]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{conv}.bias"] = _leaf(params[conv]["bias"])
    for fc in ("fc1", "fc2", "fc3"):
        _dense(params[fc], fc, sd)
    return sd
