"""The port's parameters <-> the JAX package's flax trees, both ways.

Each model family the two packages share has one layout table: a row per
parameter, ``(torch name, flax key path, perm)``, where ``{i}`` stands for
a layer index (several in a row: one index each, in order) and ``perm``
takes the flax array's axes to the torch tensor's (``None``: the same
array). Dense kernels go from flax's
``[in, out]`` to ``[out, in]`` (the fused QKV keeps its ``[q | k | v]``
column order as row order), convolution kernels from ``[kh, kw, in, out]``
to ``[out, in, kh, kw]``, LayerNorm ``scale`` becomes ``weight``, a flax
block ``h_{i}`` becomes ``h.{i}``, and ``wte`` keeps its padded vocab.
Both directions come from the same rows:

* :func:`flax_to_state_dict` (GPT-2, MoE-GPT),
  :func:`gptj_flax_to_state_dict`, :func:`bert_flax_to_state_dict`,
  :func:`moe_inference_flax_to_state_dict`,
  :func:`simple_flax_to_state_dict` (``SimpleModel`` / ``LinearStack`` /
  ``EmbeddingModel``), :func:`cifar_flax_to_state_dict` and
  :func:`tiled_flax_to_state_dict` take a flax
  params tree of numpy arrays (``jax.tree.map(np.asarray, params)``) to
  the port model's state_dict, and :func:`state_dict_to_flax` back;
* :func:`layout_of` finds the table that names every parameter of a port
  module; with it the engine writes each per-parameter leaf (the params,
  an optimizer's ``mu`` / ``nu`` / ``momentum`` / ``accum``) at its flax
  key path and layout, and :func:`from_flax` reads a flax tree back;
* :func:`layer_to_jax` / :func:`layer_from_jax` carry one layer's leaves
  of the layered ``Zero3OffloadEngine`` (its ``state_dict``: masters and
  moments, a list a layer) between the port's order and layout and
  JAX's (the layer's flax tree flattened with its keys sorted);
* :func:`flat_to_jax` / :func:`flat_from_jax` carry the Adam sweep's one
  padded vector (``AdamSweepState.mu`` / ``nu``) between the port's leaf
  order (``named_parameters()``, ``[out, in]`` weights) and JAX's (the
  flax tree flattened with its dict keys sorted, so ``h_10`` comes before
  ``h_2``; ``[in, out]`` kernels).

This module imports neither jax nor flax.
"""

import re

import numpy as np
import torch

_T = (1, 0)                   # a dense kernel
_CONV = (3, 2, 0, 1)          # a convolution kernel


def _dense(t, f):
    return ((f"{t}.weight", f"{f}/kernel", _T), (f"{t}.bias", f"{f}/bias",
                                                 None))


def _norm(t, f):
    return ((f"{t}.weight", f"{f}/scale", None), (f"{t}.bias", f"{f}/bias",
                                                  None))


def _raw(*names, t="", f=""):
    return tuple((t + n, f + n, None) for n in names)


def _moe(t, f):
    """A ``moe.layer.MoE`` at torch prefix ``t`` and flax prefix ``f``: the
    gate ``wg`` [M, E] and the stacked experts [E, in, out] keep flax's
    layout; MoS's ``mlp`` and ``coefficient`` are plain denses."""
    experts = tuple(
        (f"{t}.deepspeed_moe.deepspeed_experts.{fc}.{p}",
         f"{f}/deepspeed_moe/deepspeed_experts/{fc}/{q}", None)
        for fc in ("fc1", "fc2") for p, q in (("weight", "kernel"),
                                               ("bias", "bias")))
    return ((f"{t}.deepspeed_moe.gate.wg", f"{f}/deepspeed_moe/gate/wg",
             None),) + experts + _dense(f"{t}.mlp.fc1", f"{f}/mlp/fc1") \
        + _dense(f"{t}.mlp.fc2", f"{f}/mlp/fc2") \
        + _dense(f"{t}.coefficient", f"{f}/coefficient")


def _attention_block(t, f):
    return (_norm(f"{t}.ln_1", f"{f}/ln_1") + _norm(f"{t}.ln_2", f"{f}/ln_2")
            + _dense(f"{t}.attn.qkv", f"{f}/attn/qkv")
            + _dense(f"{t}.attn.proj", f"{f}/attn/proj"))


GPT2_LAYOUT = (
    _raw("wte", "wpe")
    + _attention_block("h.{i}", "h_{i}")
    + _dense("h.{i}.mlp.fc", "h_{i}/mlp/fc")
    + _dense("h.{i}.mlp.proj", "h_{i}/mlp/proj")
    # MoE-GPT's blocks (JAX gpt2.py:254-277)
    + _moe("h.{i}.moe", "h_{i}/moe")
    + _norm("ln_f", "ln_f"))

# a stack of ops.transformer.moe_inference.DeepSpeedMoEInference layers
# (layers.{i} / layers_{i}), or one such layer at the top
MOE_INFERENCE_LAYOUT = (_attention_block("layers.{i}", "layers_{i}")
                        + _moe("layers.{i}.moe", "layers_{i}/moe"))
MOE_LAYER_LAYOUT = (_norm("ln_1", "ln_1") + _norm("ln_2", "ln_2")
                    + _dense("attn.qkv", "attn/qkv")
                    + _dense("attn.proj", "attn/proj") + _moe("moe", "moe"))

BERT_LAYOUT = (
    _raw("word_embeddings", "position_embeddings", "token_type_embeddings",
         "mlm_bias")
    + _norm("emb_ln", "emb_ln")
    # the fused encoder layer: raw LayerNorm and intermediate params
    + _raw("attn_ln_gamma", "attn_ln_beta", "ln_gamma", "ln_beta",
           "inter_w", "inter_b", t="layer.{i}.layer.", f="layer_{i}/layer/")
    + _dense("layer.{i}.layer.attn_qkv", "layer_{i}/layer/attn_qkv")
    + _dense("layer.{i}.layer.attn_out", "layer_{i}/layer/attn_out")
    + _dense("layer.{i}.layer.output_w", "layer_{i}/layer/output_w")
    # the sparse layer: flax denses and LayerNorms
    + _dense("layer.{i}.attention.qkv", "layer_{i}/attention/qkv")
    + _dense("layer.{i}.attn_out", "layer_{i}/attn_out")
    + _dense("layer.{i}.fc", "layer_{i}/fc")
    + _dense("layer.{i}.out", "layer_{i}/out")
    + _norm("layer.{i}.attn_ln", "layer_{i}/attn_ln")
    + _norm("layer.{i}.out_ln", "layer_{i}/out_ln")
    + _dense("mlm_dense", "mlm_dense") + _norm("mlm_ln", "mlm_ln"))

# SimpleModel and LinearStack (flax Dense_{i}); EmbeddingModel
SIMPLE_LAYOUT = _dense("layers.{i}", "Dense_{i}")
EMBEDDING_LAYOUT = (("wte.weight", "wte/embedding", None),) + \
    _dense("dense", "Dense_0")

CIFAR_LAYOUT = (
    ("conv1.weight", "conv1/kernel", _CONV), ("conv1.bias", "conv1/bias",
                                              None),
    ("conv2.weight", "conv2/kernel", _CONV), ("conv2.bias", "conv2/bias",
                                              None),
    *_dense("fc1", "fc1"), *_dense("fc2", "fc2"), *_dense("fc3", "fc3"))

# runtime/zero/tiling.py: TiledLinear's tile grid (tile_{ic}_{oc}, the
# bias on the last input tile) and TiledLinearReturnBias's
TILED_LAYOUT = (_dense("tile_{i}_{i}", "tile_{i}_{i}")
                + _dense("tiles.tile_{i}_{i}", "tiles/tile_{i}_{i}")
                + _raw("bias"))

# the layers of models/gpt2.gpt2_offload_layers (JAX gpt2.py:280-345):
# the embedding is GPT2_LAYOUT's wte and wpe; a _PipeBlock holds the GPT-2
# block under "block"; the head its ln_f and the untied lm_head [V, E]
OFFLOAD_BLOCK_LAYOUT = (_attention_block("block", "block")
                        + _dense("block.mlp.fc", "block/mlp/fc")
                        + _dense("block.mlp.proj", "block/mlp/proj"))
OFFLOAD_HEAD_LAYOUT = _norm("ln_f", "ln_f") + _raw("lm_head")

# models/gptj.GPTJForCausalLM (JAX gptj.py): bias-free qkv and out_proj,
# biased fc_in / fc_out, the untied biased lm_head; no position table
GPTJ_LAYOUT = (
    _raw("wte") + _norm("h.{i}.ln_1", "h_{i}/ln_1")
    + (("h.{i}.qkv.weight", "h_{i}/qkv/kernel", _T),
       ("h.{i}.out_proj.weight", "h_{i}/out_proj/kernel", _T))
    + _dense("h.{i}.fc_in", "h_{i}/fc_in")
    + _dense("h.{i}.fc_out", "h_{i}/fc_out")
    + _norm("ln_f", "ln_f") + _dense("lm_head", "lm_head"))

LAYOUTS = {"gpt2": GPT2_LAYOUT, "bert": BERT_LAYOUT,
           "embedding": EMBEDDING_LAYOUT, "simple": SIMPLE_LAYOUT,
           "cifar": CIFAR_LAYOUT, "moe_inference": MOE_INFERENCE_LAYOUT,
           "moe_layer": MOE_LAYER_LAYOUT, "tiled": TILED_LAYOUT,
           "offload_block": OFFLOAD_BLOCK_LAYOUT,
           "offload_head": OFFLOAD_HEAD_LAYOUT, "gptj": GPTJ_LAYOUT}


def _pattern(template):
    return re.compile("^" + r"(\d+)".join(
        re.escape(part) for part in template.split("{i}")) + "$")


_PATTERNS = {family: [(_pattern(t), _pattern(f), t, f, perm)
                      for t, f, perm in rows]
             for family, rows in LAYOUTS.items()}


def _translate(family, name, side):
    """The other side's name and the perm of the row matching ``name``
    (``side`` 0: a torch name, 1: a flax path "a/b/c"), or None."""
    for row in _PATTERNS[family]:
        m = row[side].match(name)
        if m:
            other = row[3 - side]
            for index in m.groups():
                other = other.replace("{i}", index, 1)
            return other, row[4]
    return None


def inverse(perm):
    """The axes that undo ``perm``."""
    return None if perm is None else tuple(int(a) for a in np.argsort(perm))


def layout_of(names):
    """``{torch name: (flax key path tuple, perm)}`` from the first family
    whose table names every one of ``names``; None when none does (a
    user module, saved under its own names)."""
    names = list(names)
    for family in LAYOUTS:
        hits = [_translate(family, n, 0) for n in names]
        if names and all(hits):
            return {n: (tuple(f.split("/")), perm)
                    for n, (f, perm) in zip(names, hits)}
    return None


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _permute(x, perm):
    if perm is None:
        return x
    if isinstance(x, torch.Tensor):
        return x.permute(perm)
    return np.transpose(x, perm)


def nest(pairs):
    """A nested dict from ``(key path tuple, leaf)`` pairs."""
    out = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def from_flax(table, tree):
    """The torch-named tree of ``table``'s parameters from a nested flax
    dict, each leaf permuted to the torch layout; ``KeyError`` names the
    first flax path the tree lacks."""
    out = {}
    for name, (path, perm) in table.items():
        try:
            leaf = get_path(tree, path)
        except (KeyError, TypeError):
            raise KeyError(f"flax tree has no leaf {'/'.join(path)} for "
                           f"{name}") from None
        out[name] = _permute(leaf, perm)
    return out


def keystr(path):
    """``jax.tree_util.keystr`` of a dict key path: ``['h_0']['ln_1']...``."""
    return "".join(f"[{k!r}]" for k in path)


def jax_order(table, names):
    """``names`` in the order JAX flattens their flax tree (dict keys
    sorted at every level)."""
    return sorted(names, key=lambda n: table[n][0])


def flat_to_jax(vec, table, names, shapes):
    """The sweep's flat vector from the port's leaf order (``names`` with
    torch ``shapes``, back to back from 0) to JAX's: same padded length,
    each leaf in the flax layout. Works on the vector's device."""
    offs, off = {}, 0
    for name, shape in zip(names, shapes):
        size = int(np.prod(shape)) if shape else 1
        offs[name] = (off, size, shape)
        off += size
    out = torch.zeros_like(vec)
    dst = 0
    for name in jax_order(table, names):
        start, size, shape = offs[name]
        leaf = vec[start:start + size].view(shape)
        out[dst:dst + size].view(_flax_shape(table, name, shape)).copy_(
            _permute(leaf, inverse(table[name][1])))
        dst += size
    return out


def flat_from_jax(vec, table, names, shapes, n_pad):
    """The inverse of :func:`flat_to_jax`, into a vector of ``n_pad``
    (the port's own padded length; the saved vector's length is read from
    the vector itself)."""
    sizes = {n: (int(np.prod(s)) if s else 1) for n, s in zip(names, shapes)}
    total = sum(sizes.values())
    if vec.numel() < total:
        raise ValueError(f"flat vector of {vec.numel()} elements holds "
                         f"fewer than the model's {total}")
    shape_of = dict(zip(names, shapes))
    pieces, off = {}, 0
    for name in jax_order(table, names):
        size = sizes[name]
        flax = vec[off:off + size].view(
            _flax_shape(table, name, shape_of[name]))
        pieces[name] = _permute(flax, table[name][1])
        off += size
    out = torch.zeros(n_pad, dtype=vec.dtype, device=vec.device)
    dst = 0
    for name in names:
        out[dst:dst + sizes[name]].view(shape_of[name]).copy_(pieces[name])
        dst += sizes[name]
    return out


def _flax_shape(table, name, shape):
    perm = inverse(table[name][1])
    return tuple(shape) if perm is None else tuple(shape[a] for a in perm)


def _leaf(x):
    return torch.from_numpy(np.array(x, copy=True))


def _from_flax_params(family, params):
    """A flax params tree (numpy leaves) to the state_dict of the family's
    port model, every leaf matched by a row."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for path, leaf in _flat_paths(params):
        hit = _translate(family, "/".join(path), 1)
        if hit is None:
            raise KeyError(f"no {family} layout row for flax leaf "
                           f"{'/'.join(path)}")
        name, perm = hit
        sd[name] = _leaf(_permute(np.asarray(leaf), perm))
    return sd


def flax_to_state_dict(params) -> dict:
    """Convert a flax GPT-2 params tree (numpy leaves) to a state_dict
    (with rope positions the tree has no ``wpe``, nor the state_dict)."""
    return _from_flax_params("gpt2", params)


def gptj_flax_to_state_dict(params) -> dict:
    """Convert a flax GPT-J params tree (numpy leaves; JAX's
    ``GPTJForCausalLM``, or ``models.gptj.hf_gptj_to_params``) to the
    state_dict of ``deepspeed_tpu_torch.models.gptj.GPTJForCausalLM``."""
    return _from_flax_params("gptj", params)


def state_dict_to_flax(state_dict) -> dict:
    """The inverse of the ``*_flax_to_state_dict`` functions: a port
    model's state_dict (or ``named_parameters()``) as the nested flax
    params tree of its family, numpy leaves in flax's layout (bf16 as
    fp32). ``KeyError`` when no family's table names every tensor."""
    table = layout_of(state_dict)
    if table is None:
        raise KeyError("no layout table names every tensor of the "
                       "state_dict")

    def host(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return nest((path, np.ascontiguousarray(
        _permute(host(state_dict[n]), inverse(perm))))
        for n, (path, perm) in table.items())


def bert_flax_to_state_dict(params) -> dict:
    """Convert a flax BERT params tree (numpy leaves) to the state_dict of
    ``deepspeed_tpu_torch.models.bert.BertForPreTraining``: dense kernels
    transposed, LayerNorm ``scale`` -> ``weight``, the fused layer's raw
    params (``inter_w`` [in, out], ``*_gamma`` / ``*_beta``) as they are,
    ``layer_{i}`` -> ``layer.{i}``; a sparse layer's ``attention/qkv``,
    ``attn_out``, ``fc`` and ``out`` denses and ``attn_ln`` / ``out_ln``
    keep their names."""
    return _from_flax_params("bert", params)


def simple_flax_to_state_dict(params) -> dict:
    """Convert the flax params of ``SimpleModel`` or ``LinearStack``
    (denses ``Dense_{i}``) or ``EmbeddingModel`` (``wte`` and
    ``Dense_0``) to the port model's state_dict: ``layers.{i}``, or
    ``wte`` and ``dense``."""
    inner = params.get("params", params)
    return _from_flax_params("embedding" if "wte" in inner else "simple",
                             params)


def moe_inference_flax_to_state_dict(params) -> dict:
    """Convert the flax params of one ``DeepSpeedMoEInference`` layer, or
    of a stack of them named ``layers_{i}``, to the state_dict of the
    port's layer (or of an ``nn.ModuleList`` named ``layers``)."""
    inner = params.get("params", params)
    return _from_flax_params("moe_inference" if "layers_0" in inner
                             else "moe_layer", params)


def cifar_flax_to_state_dict(params) -> dict:
    """Convert the flax ``CifarNet`` params to the port net's state_dict:
    conv kernels from ``[kh, kw, in, out]`` to ``[out, in, kh, kw]``,
    dense kernels transposed."""
    return _from_flax_params("cifar", params)


def tiled_flax_to_state_dict(params) -> dict:
    """Convert the flax params of a ``TiledLinear`` (``tile_{ic}_{oc}``
    denses) or ``TiledLinearReturnBias`` (``tiles`` and ``bias``) to the
    state_dict of ``runtime.zero.tiling``'s module."""
    return _from_flax_params("tiled", params)


def layer_to_jax(table, names, leaves):
    """One layer's leaves (``leaves[i]`` of torch parameter ``names[i]``,
    numpy or torch) in JAX's order and flax's layout, as the JAX
    ``Zero3OffloadEngine`` lists them (``jax.tree.leaves`` of the layer's
    params); ``table`` is :func:`layout_of` the names, or None for a
    layer no family names (kept in the port's order and layout)."""
    if table is None:
        return list(leaves)
    at = dict(zip(names, leaves))
    return [_permute(at[n], inverse(table[n][1]))
            for n in jax_order(table, names)]


def layer_from_jax(table, names, shapes, leaves):
    """The inverse of :func:`layer_to_jax`: the leaves in ``names``' order
    and the torch layout (views of the arrays given), each checked
    against its torch shape in ``shapes``."""
    leaves = list(leaves)
    if len(leaves) != len(names):
        raise ValueError(f"a layer of {len(names)} tensors got "
                         f"{len(leaves)} leaves")
    if table is None:
        got = dict(zip(names, leaves))
    else:
        got = {n: _permute(np.asarray(x), table[n][1])
               for n, x in zip(jax_order(table, names), leaves)}
    for n, shape in zip(names, shapes):
        if tuple(np.shape(got[n])) != tuple(shape):
            raise ValueError(f"leaf for {n} has shape "
                             f"{tuple(np.shape(got[n]))}, the layer's is "
                             f"{tuple(shape)}")
    return [got[n] for n in names]
