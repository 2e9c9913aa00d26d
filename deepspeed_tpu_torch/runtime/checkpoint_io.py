"""Shard-aware checkpoint files (counterpart of
``deepspeed_tpu/runtime/checkpoint_io.py``), in the JAX package's format.

Every file goes through tmp + fsync + ``os.replace`` + a directory
fsync, so a file exists whole or not at all; a crash leaves at most a
``*.tmp.<pid>`` sibling, which every reader here skips. A per-tag
``manifest.json`` (schema ``deepspeed_tpu.ckpt_manifest/1``) written
last makes "this tag is loadable" a checked property, and the ``latest``
pointer moves only after it.

The optimizer and parameter payloads are the JAX ``shards-v1`` record:
``{path: {"shape", "dtype", "shards": [(key, ndarray)]}}``, each shard
keyed by its global index range, so a load reassembles by index from any
number of files, whatever the world size that wrote them. Each rank's
file holds its ZeRO-1 boxes; without a process group each leaf is one
shard with the full-range key JAX writes for an array on one device. Only numpy arrays and Python objects go into the pickles,
never a ``torch.Tensor``, so either package reads the other's files.

Spans and byte counters go through the port's ``telemetry/tracer.py``
and ``telemetry/metrics.py`` (``checkpoint_write_bytes_total{kind}``,
``checkpoint_read_bytes_total{kind}``). The JAX goodput ledger's
attribution calls are left out: the ledger is not ported.

MoE tags keep the JAX layout (JAX ``checkpoint_io.py:357-466``): each MoE
layer's experts go one file per *global* expert,
``layer_{L}_expert_{E}_mp_rank_00_model_states.pt``, holding that
expert's leaves under their ``/``-joined paths, and the model-states
``module`` tree keeps the rest (``has_moe_layers``,
``moe_layer_prefixes``, ``moe_expert_counts`` beside it). ``L`` orders
the layers by their sorted path prefixes. The shard payloads hold the
expert leaves whole-layer shaped ``[E, ...]``, as JAX's do.
"""

import json
import os
import pickle
import time

import numpy as np

from deepspeed_tpu_torch.telemetry.metrics import get_registry
from deepspeed_tpu_torch.telemetry.tracer import trace_span

_TMP_MARK = ".tmp."

MANIFEST_FILE = "manifest.json"
MANIFEST_SCHEMA = "deepspeed_tpu.ckpt_manifest/1"


def _fsync_dir(dirname):
    """fsync the directory that holds a renamed file (best effort: not
    every filesystem hands out directory descriptors)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, write_fn):
    """``write_fn(fileobj)`` into a tmp sibling, fsync, rename into place,
    fsync the directory. Returns the bytes written."""
    tmp = f"{path}{_TMP_MARK}{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        # only after a failure: the rename took the tmp name away
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    _fsync_dir(os.path.dirname(path))
    return os.path.getsize(path)


def dump_file(obj, path, kind="checkpoint"):
    """Pickle ``obj`` to ``path`` atomically, in a ``checkpoint/write/<kind>``
    span, the bytes counted into ``checkpoint_write_bytes_total{kind}``.

    Protocol 5: an array's bytes go from its buffer to the file with the
    GIL released in the write, where protocol 4 (the JAX writer's
    default) first copies each array into a bytes object under the GIL,
    stalling a training loop that runs beside a background persist.
    ``pickle.load`` reads either."""
    with trace_span(f"checkpoint/write/{kind}", path=os.path.basename(path)):
        nbytes = _atomic_write(
            path, lambda f: pickle.dump(obj, f, protocol=5))
    get_registry().counter("checkpoint_write_bytes_total",
                           "bytes written by checkpoint saves",
                           labels={"kind": kind}).inc(nbytes)
    return nbytes


def load_file(path, kind="checkpoint"):
    """Unpickle ``path`` in a read span; bytes into
    ``checkpoint_read_bytes_total{kind}``."""
    with trace_span(f"checkpoint/read/{kind}", path=os.path.basename(path)):
        with open(path, "rb") as f:
            try:
                obj = pickle.load(f)
            except ModuleNotFoundError as e:
                if e.name != "ml_dtypes":
                    raise
                raise ValueError(
                    f"{path} holds bfloat16 numpy arrays, which need "
                    f"ml_dtypes to unpickle; save those tensors in fp32") \
                    from None
    get_registry().counter("checkpoint_read_bytes_total",
                           "bytes read by checkpoint loads",
                           labels={"kind": kind}).inc(os.path.getsize(path))
    return obj


# -------------------------------------------------------------- manifest


def write_manifest(tag_dir, meta=None):
    """Write the tag's manifest atomically, last: every durable file of
    ``tag_dir`` with its size, merged with ``meta`` (tag, world sizes,
    step) for the fallback scan."""
    files = {}
    for name in sorted(os.listdir(tag_dir)):
        if name == MANIFEST_FILE or _TMP_MARK in name:
            continue
        path = os.path.join(tag_dir, name)
        if os.path.isfile(path):
            files[name] = os.path.getsize(path)
    doc = {"schema": MANIFEST_SCHEMA, "files": files}
    doc.update(meta or {})
    payload = json.dumps(doc, indent=2, sort_keys=True).encode()
    _atomic_write(os.path.join(tag_dir, MANIFEST_FILE),
                  lambda f: f.write(payload))
    return doc


def load_manifest(tag_dir):
    path = os.path.join(tag_dir, MANIFEST_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _manifest_mismatch(tag_dir, files):
    """The first contradiction between a manifest's files and the disk,
    or None."""
    for name, size in files.items():
        path = os.path.join(tag_dir, name)
        if not os.path.isfile(path):
            return f"manifest lists {name!r} but it is missing"
        if size is not None and os.path.getsize(path) != size:
            return (f"{name!r} is {os.path.getsize(path)} bytes but the "
                    f"manifest recorded {size}")
    return None


def verify_tag(tag_dir):
    """``(status, detail)`` of the tag at ``tag_dir``: ``"intact"``
    (manifest and every listed file at its size), ``"legacy"`` (files but
    no manifest: an old save or one cut before the manifest),
    ``"missing"`` (no directory, or an empty one) or ``"corrupt"`` (the
    manifest is contradicted on disk)."""
    if not os.path.isdir(tag_dir):
        return "missing", "no such directory"
    entries = [n for n in os.listdir(tag_dir) if _TMP_MARK not in n]
    if not entries:
        return "missing", "directory is empty"
    if MANIFEST_FILE not in entries:
        return "legacy", ("no completeness manifest (pre-manifest save or "
                          "a save interrupted before the manifest write)")
    try:
        files = load_manifest(tag_dir)["files"]
    except Exception as e:
        return "corrupt", f"manifest unreadable: {e}"
    mismatch = _manifest_mismatch(tag_dir, files)
    if mismatch:
        return "corrupt", mismatch
    return "intact", ""


def newest_intact_tag(load_dir, exclude=()):
    """The newest manifest-verified tag under ``load_dir`` (by recorded
    global step, then manifest mtime), or None. Tags without a manifest
    are never chosen: they cannot be told from an interrupted save."""
    exclude = set(str(t) for t in (exclude or ()))
    best = None
    try:
        names = os.listdir(load_dir)
    except OSError:
        return None
    for name in names:
        tag_dir = os.path.join(load_dir, name)
        if name in exclude or not os.path.isdir(tag_dir):
            continue
        try:
            doc = load_manifest(tag_dir)
            files = doc["files"]
        except Exception:
            continue
        if _manifest_mismatch(tag_dir, files):
            continue
        key = (doc.get("global_steps", -1),
               os.path.getmtime(os.path.join(tag_dir, MANIFEST_FILE)))
        if best is None or key > best[0]:
            best = (key, name)
    return best[1] if best else None


def write_latest(save_dir, latest_file, tag):
    """Point ``latest`` at ``tag`` atomically: readers see the old tag or
    the new one."""
    payload = str(tag).encode()
    _atomic_write(os.path.join(save_dir, latest_file),
                  lambda f: f.write(payload))


def wait_for_files(paths, timeout_s=300.0, poll_s=0.05,
                   describe="checkpoint files"):
    """Block until every path exists (the gate before the manifest: other
    ranks' shard files land by their own atomic renames). File polling,
    no collectives, so it is safe on the background writer's thread."""
    deadline = time.monotonic() + timeout_s
    missing = [p for p in paths if not os.path.isfile(p)]
    while missing:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"timed out after {timeout_s:.0f}s waiting for {describe}: "
                f"missing {[os.path.basename(p) for p in missing[:4]]}"
                f"{' ...' if len(missing) > 4 else ''}")
        time.sleep(poll_s)
        missing = [p for p in missing if not os.path.isfile(p)]


# ---------------------------------------------------------------- shards


def full_key(shape):
    """The index key JAX writes for the one shard of an array on one
    device: ``((0, d0), (0, d1), ...)``; ``()`` for a scalar."""
    return tuple((0, int(d)) for d in shape)


def tree_local_shards(tree, boxes=None):
    """The ``shards-v1`` payload of ``tree``, a mapping of leaf path to a
    tensor, ndarray or number. ``boxes`` maps a path to ``(key, shape)``
    when its leaf is one rank's box of a larger array: ``key`` its global
    index ranges, ``shape`` the whole array's; every other leaf is one
    full-range shard. A tensor's host array may share its memory: a
    payload that must outlive the next in-place update is built from
    copies."""
    out = {}
    boxes = boxes or {}
    for path, leaf in tree.items():
        arr = (leaf.detach().cpu().numpy() if hasattr(leaf, "detach")
               else np.asarray(leaf))
        key, shape = boxes.get(path, (full_key(arr.shape), arr.shape))
        if tuple(b - a for a, b in key) != tuple(arr.shape):
            raise ValueError(f"leaf {path}: box {key} does not hold an "
                             f"array of shape {tuple(arr.shape)}")
        out[path] = {"shape": tuple(int(d) for d in shape),
                     "dtype": str(arr.dtype), "shards": [(tuple(key), arr)]}
    return out


def _np_dtype(pstr, dtype):
    try:
        return np.dtype(dtype)
    except TypeError:
        raise ValueError(
            f"checkpoint leaf {pstr} is {dtype}, which numpy cannot hold "
            f"without ml_dtypes; save that tensor in fp32") from None


def assemble(files_payloads):
    """Merge shard payloads (from one or more files) into full ndarrays;
    raises ``ValueError`` naming a leaf whose shards do not cover it."""
    merged, filled = {}, {}
    for payload in files_payloads:
        for pstr, rec in payload.items():
            shape = tuple(rec["shape"])
            dtype = _np_dtype(pstr, rec["dtype"])
            shards = rec["shards"]
            if pstr not in merged and len(shards) == 1 and \
                    shards[0][0] in ((), full_key(shape)):
                # one shard of the whole leaf (world size 1): as it is
                merged[pstr] = np.asarray(shards[0][1])
                continue
            if pstr not in merged:
                merged[pstr] = np.zeros(shape, dtype)
                filled[pstr] = np.zeros(shape, dtype=bool)
            elif pstr not in filled:
                continue        # already whole
            for key, data in rec["shards"]:
                if key == ():
                    merged[pstr] = np.asarray(data)
                    filled[pstr] = np.ones_like(filled[pstr])
                    continue
                slices = tuple(slice(a, b) for a, b in key)
                merged[pstr][slices] = data
                filled[pstr][slices] = True
    for pstr, mask in filled.items():
        if not mask.all():
            raise ValueError(
                f"checkpoint incomplete: leaf {pstr} missing shards "
                f"({mask.sum()}/{mask.size} elements covered)")
    return merged


def restore_tree(paths, files_payloads):
    """``{path: ndarray}`` for each of ``paths`` from the shard payloads;
    ``KeyError`` names the first path the checkpoint lacks (the JAX
    ``restore_tree`` contract)."""
    merged = assemble(files_payloads)
    out = {}
    for pstr in paths:
        if pstr not in merged:
            raise KeyError(f"checkpoint missing leaf {pstr}")
        out[pstr] = merged[pstr]
    return out


# ------------------------------------------------------- MoE expert files

MOE_EXPERT_KEY = "deepspeed_experts"


def moe_expert_file(tag_dir, layer_id, expert_id, mp_rank=0):
    return os.path.join(
        tag_dir,
        f"layer_{layer_id}_expert_{expert_id}_mp_rank_{mp_rank:02d}"
        "_model_states.pt")


def _expert_files(tag_dir, layer_id="*", mp_rank=0):
    import glob
    return glob.glob(os.path.join(
        tag_dir, f"layer_{layer_id}_expert_*_mp_rank_{mp_rank:02d}"
        "_model_states.pt"))


def walk_paths(tree, prefix=()):
    """``("a/b/c", leaf)`` for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk_paths(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def moe_prefix(path):
    """The MoE layer of a ``/``-joined leaf path (the part before
    ``deepspeed_experts``), or None for a leaf that is not an expert's."""
    parts = path.split("/")
    if MOE_EXPERT_KEY not in parts:
        return None
    return "/".join(parts[:parts.index(MOE_EXPERT_KEY)])


def split_moe_state(params_np):
    """(non_moe_tree, prefixes, experts): ``experts`` lists, a layer in
    the order of the sorted ``prefixes``, ``{path: stacked [E, ...]
    array}`` (JAX ``split_moe_state``)."""
    by_prefix = {}
    for path, leaf in walk_paths(params_np):
        prefix = moe_prefix(path)
        if prefix is not None:
            by_prefix.setdefault(prefix, {})[path] = leaf
    prefixes = sorted(by_prefix)

    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()
                    if str(k) != MOE_EXPERT_KEY}
        return tree

    return strip(params_np), prefixes, [by_prefix[p] for p in prefixes]


def remove_stale_expert_files(tag_dir, counts, mp_rank=0):
    """Remove this mp rank's expert files that a save with ``counts``
    experts a layer does not write (a re-save of a tag with fewer layers
    or experts must not leave orphans for a restore to glob). The files
    it writes are left alone, so other writers' files may land
    meanwhile."""
    import re
    for f in _expert_files(tag_dir, mp_rank=mp_rank):
        m = re.search(r"layer_(\d+)_expert_(\d+)_", os.path.basename(f))
        lid, eid = int(m.group(1)), int(m.group(2))
        if lid >= len(counts) or eid >= counts[lid]:
            os.remove(f)


def write_expert_files(tag_dir, experts, block=0, mp_rank=0):
    """One file an expert: ``experts`` lists a layer's ``{path: [n, ...]
    array}``, the ``block``-th run of n of the layer's experts (global ids
    ``block · n .. block · n + n - 1``: an expert-parallel rank's)."""
    with trace_span("checkpoint/save_moe_experts"):
        for lid, layer in enumerate(experts):
            num = next(iter(layer.values())).shape[0]
            for j in range(num):
                sd = {path: np.asarray(leaf[j])
                      for path, leaf in layer.items()}
                dump_file(sd, moe_expert_file(tag_dir, lid, block * num + j,
                                              mp_rank), kind="moe_expert")


def save_moe_experts(tag_dir, params_np, mp_rank=0):
    """Write every expert's file from a whole tree; returns (non_moe_tree,
    prefixes, expert_counts) for the model-states metadata (JAX
    ``save_moe_experts``)."""
    non_moe, prefixes, experts = split_moe_state(params_np)
    counts = [next(iter(layer.values())).shape[0] for layer in experts]
    if experts:
        remove_stale_expert_files(tag_dir, counts, mp_rank)
    write_expert_files(tag_dir, experts, mp_rank=mp_rank)
    return non_moe, prefixes, counts


def restore_moe_experts(tag_dir, module_np, prefixes, mp_rank=0,
                        expert_counts=None):
    """Re-stack the per-expert files into the module tree (JAX
    ``restore_moe_experts``). Expert ids must run contiguously from 0 (a
    missing file would shift every later expert), and with
    ``expert_counts`` (the tag's metadata) the count must match."""
    import re
    for lid in range(len(prefixes)):
        files = _expert_files(tag_dir, lid, mp_rank)
        pat = os.path.join(tag_dir, f"layer_{lid}_expert_*_mp_rank_"
                                    f"{mp_rank:02d}_model_states.pt")
        if not files:
            raise FileNotFoundError(
                f"MoE checkpoint is missing expert files: {pat}")
        by_eid = sorted(
            (int(re.search(r"_expert_(\d+)_", os.path.basename(f)).group(1)),
             f) for f in files)
        eids = [e for e, _ in by_eid]
        if eids != list(range(len(eids))):
            raise FileNotFoundError(
                f"MoE checkpoint layer {lid} has non-contiguous expert "
                f"files (ids {eids}); a partial checkpoint would silently "
                "index-shift experts")
        if expert_counts is not None and len(eids) != expert_counts[lid]:
            raise FileNotFoundError(
                f"MoE checkpoint layer {lid} has {len(eids)} expert files "
                f"but the checkpoint metadata records "
                f"{expert_counts[lid]} experts")
        payloads = [load_file(f, kind="moe_expert") for _, f in by_eid]
        for path in payloads[0]:
            stacked = np.stack([p[path] for p in payloads], axis=0)
            node = module_np
            parts = path.split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = stacked
    return module_np


def module_tree(sd, path):
    """The whole ``module`` tree of a model-states dict read from
    ``path``: the expert files of its tag stacked back in."""
    module = sd.get("module")
    if module is not None and sd.get("has_moe_layers"):
        module = restore_moe_experts(
            os.path.dirname(str(path)), module,
            sd.get("moe_layer_prefixes", []),
            expert_counts=sd.get("moe_expert_counts"))
    return module
