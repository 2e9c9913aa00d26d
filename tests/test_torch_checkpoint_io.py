"""The checkpoint I/O contract of the JAX suite
(``tests/unit/test_fault_tolerance.py``, ``tests/unit/test_checkpoint_io.py``)
on the port's modules: ``runtime/checkpoint_io.py``,
``runtime/async_checkpoint.py`` and the engine's two-phase save.

* atomic files: no tmp residue, a failed dump leaves no target, the
  manifest skips tmp files, ``latest`` is replaced atomically, the newest
  intact tag prefers the higher step, ``wait_for_files`` names what is
  missing, ``assemble`` detects missing shards;
* load verification: a ``latest`` to a missing or empty tag raises
  naming it, a broken ``latest`` falls back to the newest intact tag, an
  explicit tag never falls back, a larger world's stale rank files are
  purged on re-save, a size mismatch is caught;
* crash stages: a save killed mid shard file, before the model states,
  before the manifest and before ``latest`` leaves the previous tag
  loadable, bit-exact, and the same through the background writer;
* async saves: the files equal the sync save's byte for byte, the save
  returns before they land, a second save drains the first, a background
  failure re-raises at the next save and at ``close``, a load drains.

The engine is the port's ``SimpleModel`` (hidden 32, two denses) under
Adam on the CPU.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.runtime import checkpoint_io
from deepspeed_tpu_torch.runtime.async_checkpoint import (
    AsyncCheckpointError, AsyncCheckpointWriter)

HIDDEN = 32


def _engine(async_save=False, fallback=True, persist_retries=None, seed=0):
    ckpt = {"async_save": async_save, "fallback_to_intact": fallback}
    if persist_retries is not None:
        ckpt["persist_retries"] = persist_retries
    config = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
              "zero_optimization": {"stage": 1}, "checkpoint": ckpt}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=SimpleModel(HIDDEN, nlayers=2, device="cpu", seed=seed),
        config=config, device="cpu")
    return engine


def _batch(i, bs=8):
    rng = np.random.default_rng(i)
    return (rng.standard_normal((bs, HIDDEN)).astype(np.float32),
            rng.standard_normal((bs, HIDDEN)).astype(np.float32))


def _state(engine):
    """Every piece of engine state a resume must restore, as host copies."""
    st = engine.opt_state
    return {"params": {k: p.detach().clone()
                       for k, p in engine.params.items()},
            "mu": {k: t.clone() for k, t in st.mu.items()},
            "nu": {k: t.clone() for k, t in st.nu.items()},
            "counters": (st.step, engine.step_count, engine.global_steps,
                         engine.micro_steps, engine.skipped_steps,
                         engine.global_samples, tuple(engine.scale))}


def _assert_same_state(a, b):
    assert a["counters"] == b["counters"]
    for part in ("params", "mu", "nu"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


class _Boom(RuntimeError):
    """Stands in for a kill at a chosen save stage."""


# ============================================================ atomic files
class TestAtomicIO:
    def test_dump_is_atomic_no_tmp_residue(self, tmp_path):
        p = str(tmp_path / "x.pt")
        checkpoint_io.dump_file({"a": np.arange(4)}, p)
        assert os.listdir(tmp_path) == ["x.pt"]
        assert list(checkpoint_io.load_file(p)) == ["a"]

    def test_failed_dump_leaves_no_target(self, tmp_path, monkeypatch):
        p = str(tmp_path / "x.pt")

        def die(obj, f, **kw):
            f.write(b"\x80partial")
            raise _Boom("mid pickle")

        monkeypatch.setattr(checkpoint_io.pickle, "dump", die)
        with pytest.raises(_Boom):
            checkpoint_io.dump_file({"a": 1}, p)
        monkeypatch.undo()
        assert os.listdir(tmp_path) == []

    def test_manifest_skips_tmp_files(self, tmp_path):
        (tmp_path / "real.pt").write_bytes(b"x" * 10)
        (tmp_path / "real.pt.tmp.123").write_bytes(b"junk")
        doc = checkpoint_io.write_manifest(str(tmp_path), meta={"tag": "t"})
        assert set(doc["files"]) == {"real.pt"}
        assert doc["schema"] == "deepspeed_tpu.ckpt_manifest/1"
        assert checkpoint_io.verify_tag(str(tmp_path))[0] == "intact"

    def test_write_latest_atomic(self, tmp_path):
        checkpoint_io.write_latest(str(tmp_path), "latest", "tag1")
        checkpoint_io.write_latest(str(tmp_path), "latest", "tag2")
        assert (tmp_path / "latest").read_text() == "tag2"
        assert sorted(os.listdir(tmp_path)) == ["latest"]

    def test_newest_intact_tag_prefers_higher_step(self, tmp_path):
        for tag, step in (("t1", 5), ("t2", 9)):
            d = tmp_path / tag
            d.mkdir()
            (d / "f.pt").write_bytes(b"x")
            checkpoint_io.write_manifest(str(d), meta={"global_steps": step})
        assert checkpoint_io.newest_intact_tag(str(tmp_path)) == "t2"
        assert checkpoint_io.newest_intact_tag(
            str(tmp_path), exclude=("t2",)) == "t1"

    def test_wait_for_files_timeout_names_missing(self, tmp_path):
        with pytest.raises(TimeoutError, match="ghost.pt"):
            checkpoint_io.wait_for_files(
                [str(tmp_path / "ghost.pt")], timeout_s=0.2, poll_s=0.05)

    def test_assemble_detects_missing_shards(self):
        payload = {"/x": {"shape": (4, 4), "dtype": "float32",
                          "shards": [(((0, 2), (0, 4)),
                                      np.ones((2, 4), np.float32))]}}
        with pytest.raises(ValueError, match="incomplete"):
            checkpoint_io.assemble([payload])

    def test_assemble_reassembles_index_keyed_shards(self):
        full = np.arange(16, dtype=np.float32).reshape(4, 4)
        payloads = [{"['w']": {"shape": (4, 4), "dtype": "float32",
                               "shards": [(((r, r + 2), (0, 4)),
                                           full[r:r + 2])]}}
                    for r in (2, 0)]
        np.testing.assert_array_equal(
            checkpoint_io.assemble(payloads)["['w']"], full)
        # world size 1: each leaf one full-range shard
        rec = checkpoint_io.tree_local_shards({"['w']": full})["['w']"]
        assert rec["shards"][0][0] == ((0, 4), (0, 4))
        assert rec["dtype"] == "float32"

    def test_bf16_leaf_is_a_clear_error(self, monkeypatch):
        """Where numpy has no bfloat16 (no ml_dtypes, as on the card's
        machine), a bf16 leaf is a clear error, not numpy's TypeError."""
        real = np.dtype

        def numpy_without_bf16(x, *a, **kw):
            if x == "bfloat16":
                raise TypeError("data type 'bfloat16' not understood")
            return real(x, *a, **kw)

        monkeypatch.setattr(checkpoint_io.np, "dtype", numpy_without_bf16)
        payload = {"['w']": {"shape": (2,), "dtype": "bfloat16",
                             "shards": [((), np.zeros(2, np.float32))]}}
        with pytest.raises(ValueError, match="bfloat16.*ml_dtypes"):
            checkpoint_io.assemble([payload])


# ======================================================= load verification
class TestLoadVerification:
    def test_latest_to_missing_dir_clear_error_no_fallback(self, tmp_path):
        e = _engine(fallback=False)
        e.train_batch(batch=_batch(0))
        (tmp_path / "latest").write_text("ghost")
        with pytest.raises(FileNotFoundError) as ei:
            e.load_checkpoint(str(tmp_path))
        assert "ghost" in str(ei.value)
        assert str(tmp_path / "ghost") in str(ei.value)

    def test_latest_to_empty_dir_clear_error(self, tmp_path):
        e = _engine(fallback=False)
        (tmp_path / "empty").mkdir()
        (tmp_path / "latest").write_text("empty")
        with pytest.raises(FileNotFoundError, match="directory is empty"):
            e.load_checkpoint(str(tmp_path))

    def test_no_latest_loads_nothing(self, tmp_path):
        assert _engine().load_checkpoint(str(tmp_path)) == (None, {})

    def test_latest_fallback_recovers_newest_intact(self, tmp_path):
        e = _engine()
        e.train_batch(batch=_batch(0))
        e.save_checkpoint(str(tmp_path), tag="old")
        e.train_batch(batch=_batch(1))
        e.save_checkpoint(str(tmp_path), tag="new")
        truth = _state(e)
        e.save_checkpoint(str(tmp_path), tag="broken")
        os.remove(str(tmp_path / "broken" /
                      "zero_pp_rank_0_mp_rank_00_optim_states.pt"))
        e2 = _engine(seed=1)
        path, _ = e2.load_checkpoint(str(tmp_path))
        assert os.sep + "new" + os.sep in path
        _assert_same_state(truth, _state(e2))

    def test_explicit_tag_never_falls_back(self, tmp_path):
        e = _engine()
        e.train_batch(batch=_batch(0))
        e.save_checkpoint(str(tmp_path), tag="good")
        with pytest.raises(FileNotFoundError, match="nope"):
            e.load_checkpoint(str(tmp_path), tag="nope")

    def test_resave_purges_stale_rank_shards(self, tmp_path):
        e = _engine()
        e.train_batch(batch=_batch(0))
        e.save_checkpoint(str(tmp_path), tag="t")
        truth = _state(e)
        stale = tmp_path / "t" / "zero_pp_rank_7_mp_rank_00_optim_states.pt"
        stale.write_bytes(b"\x80\x04old-world-shards")
        e.save_checkpoint(str(tmp_path), tag="t")
        assert not stale.exists()
        assert stale.name not in checkpoint_io.load_manifest(
            str(tmp_path / "t"))["files"]
        e2 = _engine(seed=1)
        e2.load_checkpoint(str(tmp_path), tag="t")
        _assert_same_state(truth, _state(e2))

    def test_size_mismatch_detected(self, tmp_path):
        e = _engine()
        e.train_batch(batch=_batch(0))
        e.save_checkpoint(str(tmp_path), tag="t")
        f = tmp_path / "t" / "mp_rank_00_model_states.pt"
        f.write_bytes(f.read_bytes() + b"garbage")
        assert checkpoint_io.verify_tag(str(tmp_path / "t"))[0] == "corrupt"
        with pytest.raises(RuntimeError, match="manifest recorded"):
            _engine(fallback=False).load_checkpoint(str(tmp_path))

    def test_legacy_tag_loads_with_a_warning(self, tmp_path, monkeypatch):
        e = _engine()
        e.train_batch(batch=_batch(0))
        e.save_checkpoint(str(tmp_path), tag="t")
        os.remove(str(tmp_path / "t" / "manifest.json"))
        assert checkpoint_io.verify_tag(str(tmp_path / "t"))[0] == "legacy"
        path, _ = _engine(seed=1).load_checkpoint(str(tmp_path), tag="t")
        assert path.endswith("mp_rank_00_model_states.pt")


# ============================================================ crash stages
class TestCrashConsistency:
    """An intact tag 'a', then a save of 'b' killed at each stage: an
    implicit load still restores 'a' bit-exact, and no file of 'b' under
    its real name is a truncated pickle."""

    def _setup(self, tmp_path, **kw):
        e = _engine(**kw)
        for i in range(3):
            e.train_batch(batch=_batch(i))
        e.save_checkpoint(str(tmp_path), tag="a")
        if e._ckpt_writer is not None:
            e._ckpt_writer.drain()
        truth = _state(e)
        for i in range(3, 5):
            e.train_batch(batch=_batch(i))
        return e, truth

    def _assert_recovers_to_a(self, tmp_path, truth):
        assert (tmp_path / "latest").read_text() == "a"
        e2 = _engine(seed=1)
        path, _ = e2.load_checkpoint(str(tmp_path))
        assert path == str(tmp_path / "a" / "mp_rank_00_model_states.pt")
        _assert_same_state(truth, _state(e2))
        for f in glob.glob(str(tmp_path / "b" / "*.pt")):
            checkpoint_io.load_file(f)

    def test_kill_mid_shard_file(self, tmp_path, monkeypatch):
        e, truth = self._setup(tmp_path)
        monkeypatch.setattr(
            checkpoint_io, "dump_file",
            lambda *a, **k: (_ for _ in ()).throw(_Boom("mid shard")))
        with pytest.raises(_Boom):
            e.save_checkpoint(str(tmp_path), tag="b")
        monkeypatch.undo()
        (tmp_path / "b" / "zero_pp_rank_0_mp_rank_00_optim_states.pt"
         ".tmp.999").write_bytes(b"\x80\x04trunc")
        self._assert_recovers_to_a(tmp_path, truth)

    def test_kill_before_model_states(self, tmp_path, monkeypatch):
        e, truth = self._setup(tmp_path)
        real = checkpoint_io.dump_file

        def die_on_model_states(obj, path, kind="checkpoint"):
            if kind == "model_states":
                raise _Boom("killed before model states")
            return real(obj, path, kind)

        monkeypatch.setattr(checkpoint_io, "dump_file", die_on_model_states)
        with pytest.raises(_Boom):
            e.save_checkpoint(str(tmp_path), tag="b")
        monkeypatch.undo()
        self._assert_recovers_to_a(tmp_path, truth)

    def test_kill_before_manifest(self, tmp_path, monkeypatch):
        e, truth = self._setup(tmp_path)
        monkeypatch.setattr(
            checkpoint_io, "write_manifest",
            lambda *a, **k: (_ for _ in ()).throw(_Boom("pre-manifest")))
        with pytest.raises(_Boom):
            e.save_checkpoint(str(tmp_path), tag="b")
        monkeypatch.undo()
        self._assert_recovers_to_a(tmp_path, truth)
        assert checkpoint_io.verify_tag(str(tmp_path / "b"))[0] == "legacy"

    def test_kill_before_latest(self, tmp_path, monkeypatch):
        e, truth = self._setup(tmp_path)
        monkeypatch.setattr(
            checkpoint_io, "write_latest",
            lambda *a, **k: (_ for _ in ()).throw(_Boom("pre-latest")))
        with pytest.raises(_Boom):
            e.save_checkpoint(str(tmp_path), tag="b")
        monkeypatch.undo()
        assert checkpoint_io.verify_tag(str(tmp_path / "b"))[0] == "intact"
        self._assert_recovers_to_a(tmp_path, truth)

    def test_async_crash_stages_equivalent(self, tmp_path, monkeypatch):
        e, truth = self._setup(tmp_path, async_save=True, persist_retries=0)
        monkeypatch.setattr(
            checkpoint_io, "write_manifest",
            lambda *a, **k: (_ for _ in ()).throw(_Boom("pre-manifest")))
        e.save_checkpoint(str(tmp_path), tag="b")
        with pytest.raises(AsyncCheckpointError):
            e._ckpt_writer.drain()
        monkeypatch.undo()
        self._assert_recovers_to_a(tmp_path, truth)


# =================================================================== async
class TestAsyncSave:
    def test_async_files_identical_to_sync(self, tmp_path):
        e = _engine(async_save=True)
        for i in range(2):
            e.train_batch(batch=_batch(i))
        e.save_checkpoint(str(tmp_path / "async"), tag="t")
        e._ckpt_writer.drain()
        e._ckpt_async = False
        e.save_checkpoint(str(tmp_path / "sync"), tag="t")
        for name in ("mp_rank_00_model_states.pt",
                     "zero_pp_rank_0_mp_rank_00_optim_states.pt"):
            a = (tmp_path / "async" / "t" / name).read_bytes()
            s = (tmp_path / "sync" / "t" / name).read_bytes()
            assert a == s, f"{name} differs between async and sync save"
        assert (tmp_path / "async" / "latest").read_text() == "t"
        e.close()

    def test_save_returns_before_files_land_and_training_continues(
            self, tmp_path, monkeypatch):
        e = _engine(async_save=True)
        e.train_batch(batch=_batch(0))
        real_dump = checkpoint_io.dump_file

        def slow_dump(obj, path, kind="checkpoint"):
            time.sleep(0.15)
            return real_dump(obj, path, kind)

        monkeypatch.setattr(checkpoint_io, "dump_file", slow_dump)
        e.save_checkpoint(str(tmp_path), tag="t")
        assert e._ckpt_writer.in_flight
        assert checkpoint_io.verify_tag(str(tmp_path / "t"))[0] != "intact"
        e.train_batch(batch=_batch(1))
        e._ckpt_writer.drain()
        assert checkpoint_io.verify_tag(str(tmp_path / "t"))[0] == "intact"
        e.close()

    def test_second_save_drains_first(self, tmp_path, monkeypatch):
        e = _engine(async_save=True)
        e.train_batch(batch=_batch(0))
        gate = threading.Event()
        real_dump = checkpoint_io.dump_file

        def gated_dump(obj, path, kind="checkpoint"):
            gate.wait(timeout=10)
            return real_dump(obj, path, kind)

        monkeypatch.setattr(checkpoint_io, "dump_file", gated_dump)
        e.save_checkpoint(str(tmp_path), tag="a")
        assert e._ckpt_writer.in_flight
        monkeypatch.setattr(checkpoint_io, "dump_file", real_dump)
        timer = threading.Timer(0.2, gate.set)
        timer.start()
        e.save_checkpoint(str(tmp_path), tag="b")
        assert checkpoint_io.verify_tag(str(tmp_path / "a"))[0] == "intact"
        e._ckpt_writer.drain()
        assert checkpoint_io.verify_tag(str(tmp_path / "b"))[0] == "intact"
        assert (tmp_path / "latest").read_text() == "b"
        e.close()

    def test_background_failure_reraises_at_next_save(self, tmp_path,
                                                      monkeypatch):
        e = _engine(async_save=True, persist_retries=0)
        e.train_batch(batch=_batch(0))
        monkeypatch.setattr(
            checkpoint_io, "dump_file",
            lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
        e.save_checkpoint(str(tmp_path), tag="a")
        e._ckpt_writer._state.thread.join()
        monkeypatch.undo()
        with pytest.raises(AsyncCheckpointError, match="disk full"):
            e.save_checkpoint(str(tmp_path), tag="b")
        e.save_checkpoint(str(tmp_path), tag="c")
        e._ckpt_writer.drain()
        assert checkpoint_io.verify_tag(str(tmp_path / "c"))[0] == "intact"
        e.close()

    def test_background_failure_reraises_at_close(self, tmp_path,
                                                  monkeypatch):
        e = _engine(async_save=True, persist_retries=0)
        e.train_batch(batch=_batch(0))
        monkeypatch.setattr(
            checkpoint_io, "dump_file",
            lambda *a, **k: (_ for _ in ()).throw(OSError("boom")))
        e.save_checkpoint(str(tmp_path), tag="a")
        e._ckpt_writer._state.thread.join()
        monkeypatch.undo()
        with pytest.raises(AsyncCheckpointError, match="boom"):
            e.close()

    def test_transient_failure_is_retried(self, tmp_path, monkeypatch):
        e = _engine(async_save=True, persist_retries=2)
        e.train_batch(batch=_batch(0))
        real_dump, calls = checkpoint_io.dump_file, []

        def flaky(obj, path, kind="checkpoint"):
            calls.append(kind)
            if len(calls) == 1:
                raise OSError("transient")
            return real_dump(obj, path, kind)

        monkeypatch.setattr(checkpoint_io, "dump_file", flaky)
        e.save_checkpoint(str(tmp_path), tag="t")
        e._ckpt_writer.drain()
        assert checkpoint_io.verify_tag(str(tmp_path / "t"))[0] == "intact"
        assert calls[0] == calls[1] == "zero_states"
        e.close()

    def test_load_drains_inflight_save(self, tmp_path, monkeypatch):
        e = _engine(async_save=True)
        for i in range(2):
            e.train_batch(batch=_batch(i))
        real_dump = checkpoint_io.dump_file
        monkeypatch.setattr(
            checkpoint_io, "dump_file",
            lambda obj, path, kind="checkpoint":
            (time.sleep(0.1), real_dump(obj, path, kind))[1])
        e.save_checkpoint(str(tmp_path), tag="t")
        path, _ = e.load_checkpoint(str(tmp_path))
        assert path.endswith("mp_rank_00_model_states.pt")
        e.close()

    def test_writer_unit_drain_and_close_semantics(self):
        w = AsyncCheckpointWriter()
        ran = []
        w.submit(lambda: ran.append(1), tag="x")
        w.drain()
        assert ran == [1]
        w.submit(lambda: (_ for _ in ()).throw(ValueError("nope")), tag="y")
        with pytest.raises(AsyncCheckpointError, match="nope"):
            w.drain()
        w.close()
        with pytest.raises(AsyncCheckpointError, match="closed"):
            w.submit(lambda: None)
