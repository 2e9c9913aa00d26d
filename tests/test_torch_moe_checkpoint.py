"""The MoE expert-file layout of the PyTorch port's checkpoints
(``runtime/checkpoint_io.py``) against the JAX package's functions
(``deepspeed_tpu/runtime/checkpoint_io.py:357-466``) on the same trees:
the file names, the per-expert payloads, the stripped model tree, the
stale-file cleanup and the missing-file and count errors."""

import os

import numpy as np
import pytest

from deepspeed_tpu.runtime import checkpoint_io as jax_ckpt
from deepspeed_tpu_torch.runtime import checkpoint_io


def _tree(experts, seed=0):
    """A MoE-GPT-shaped tree with two MoE layers (h_1, h_11: sorted path
    order puts h_11 before h_3) of ``experts`` experts."""
    rng = np.random.default_rng(seed)

    def moe():
        return {"deepspeed_moe": {
            "gate": {"wg": rng.standard_normal((8, experts)).astype(
                np.float32)},
            "deepspeed_experts": {
                fc: {"kernel": rng.standard_normal(
                    (experts, 8, 8)).astype(np.float32),
                     "bias": rng.standard_normal((experts, 8)).astype(
                         np.float32)} for fc in ("fc1", "fc2")}}}
    return {"wte": rng.standard_normal((16, 8)).astype(np.float32),
            "h_1": {"moe": moe()}, "h_11": {"moe": moe()},
            "h_3": {"ln_1": {"scale": np.ones(8, np.float32)}}}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def _files(d):
    return sorted(os.listdir(d))


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _save_both(tmp_path, tree):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(exist_ok=True)
    pdir.mkdir(exist_ok=True)
    want = jax_ckpt.save_moe_experts(str(jdir), _copy(tree))
    got = checkpoint_io.save_moe_experts(str(pdir), _copy(tree))
    return jdir, pdir, want, got


def test_save_matches_jax(tmp_path):
    jdir, pdir, want, got = _save_both(tmp_path, _tree(4))
    assert _files(pdir) == _files(jdir) == sorted(
        f"layer_{lid}_expert_{e}_mp_rank_00_model_states.pt"
        for lid in range(2) for e in range(4))
    _assert_trees_equal(got[0], want[0])
    assert got[1] == want[1] == ["h_1/moe/deepspeed_moe",
                                 "h_11/moe/deepspeed_moe"]
    assert got[2] == want[2] == [4, 4]
    for name in _files(jdir):
        _assert_trees_equal(
            checkpoint_io.load_file(str(pdir / name)),
            jax_ckpt.load_file(str(jdir / name)))


def test_restore_matches_jax_both_ways(tmp_path):
    tree = _tree(4, seed=1)
    jdir, pdir, want, got = _save_both(tmp_path, tree)
    for src in (jdir, pdir):
        mine = checkpoint_io.restore_moe_experts(
            str(src), _copy(want[0]), want[1], expert_counts=want[2])
        theirs = jax_ckpt.restore_moe_experts(
            str(src), _copy(want[0]), want[1], expert_counts=want[2])
        _assert_trees_equal(mine, tree)
        _assert_trees_equal(theirs, tree)


def test_resave_with_fewer_experts_leaves_no_orphans(tmp_path):
    _save_both(tmp_path, _tree(4))
    jdir, pdir, want, got = _save_both(tmp_path, _tree(2, seed=3))
    assert _files(pdir) == _files(jdir)
    assert len(_files(pdir)) == 4
    mine = checkpoint_io.restore_moe_experts(str(pdir), got[0], got[1],
                                             expert_counts=got[2])
    _assert_trees_equal(mine, _tree(2, seed=3))


@pytest.mark.parametrize("damage", ["missing_layer", "gap", "count"])
def test_restore_errors_match_jax(tmp_path, damage):
    jdir, pdir, want, _ = _save_both(tmp_path, _tree(4))
    counts = want[2]
    for d in (jdir, pdir):
        if damage == "missing_layer":
            for e in range(4):
                os.remove(d / f"layer_1_expert_{e}_mp_rank_00_model_states.pt")
        elif damage == "gap":
            os.remove(d / "layer_0_expert_1_mp_rank_00_model_states.pt")
    if damage == "count":
        counts = [4, 5]
    errors = []
    for mod, d in ((jax_ckpt, jdir), (checkpoint_io, pdir)):
        with pytest.raises(FileNotFoundError) as err:
            mod.restore_moe_experts(str(d), _copy(want[0]), want[1],
                                    expert_counts=counts)
        errors.append(str(err.value).replace(str(d), "<tag>"))
    assert errors[0] == errors[1]


def test_moe_prefix_and_expert_file_names():
    assert checkpoint_io.moe_prefix(
        "h_1/moe/deepspeed_moe/deepspeed_experts/fc1/kernel") == \
        "h_1/moe/deepspeed_moe"
    assert checkpoint_io.moe_prefix("h_1/moe/deepspeed_moe/gate/wg") is None
    assert checkpoint_io.moe_expert_file("t", 2, 11) == \
        jax_ckpt.moe_expert_file("t", 2, 11)
