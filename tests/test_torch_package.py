"""Package rules of the PyTorch port: it never imports JAX, flax or the
JAX package; it builds nothing on import; its entry points run on CUDA
unless the CPU is asked for by name."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.ops import _platform, op_builder
from deepspeed_tpu_torch.ops.adam import fused_adam
from deepspeed_tpu_torch.ops.lamb import fused_lamb
from deepspeed_tpu_torch.ops.quantizer import quantizer
from deepspeed_tpu_torch.ops.transformer import decode, flash, fused

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py"]
FORBIDDEN = ("jax", "flax", "deepspeed_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'deepspeed_tpu'):\n"
        "            raise ImportError('port imported ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import deepspeed_tpu_torch, deepspeed_tpu_torch.bridge\n"
        "import deepspeed_tpu_torch.models.gpt2\n"
        "import deepspeed_tpu_torch.ops.transformer.flash\n"
        "import deepspeed_tpu_torch.ops.transformer.decode\n"
        "import deepspeed_tpu_torch.ops.adam.fused_adam\n"
        "import deepspeed_tpu_torch.runtime.engine\n"
        "import deepspeed_tpu_torch.models.bert\n"
        "import deepspeed_tpu_torch.ops.transformer.fused\n"
        "import deepspeed_tpu_torch.ops.lamb.fused_lamb\n"
        "import deepspeed_tpu_torch.ops.quantizer.quantizer\n"
        "import deepspeed_tpu_torch.ops.quantizer.int8_linear\n"
        "import deepspeed_tpu_torch.runtime.quantize\n"
        "import deepspeed_tpu_torch.module_inject.module_quantize\n"
        "import deepspeed_tpu_torch.ops.sparse_attention.fused_kernels\n"
        "import deepspeed_tpu_torch.ops.sparse_attention.kernels\n"
        "import deepspeed_tpu_torch.ops.sparse_attention."
        "sparse_self_attention\n"
        "import deepspeed_tpu_torch.ops.sparse_attention."
        "sparse_attention_utils\n"
        "import deepspeed_tpu_torch.serving\n"
        "import deepspeed_tpu_torch.serving.speculative\n"
        "import deepspeed_tpu_torch.telemetry.tracer\n"
        "import deepspeed_tpu_torch.utils.logging\n"
        "import deepspeed_tpu_torch.runtime.dropout\n"
        "import deepspeed_tpu_torch.runtime.zero.partition\n"
        "import deepspeed_tpu_torch.utils.groups\n"
        "import deepspeed_tpu_torch.ops.transformer.ring\n"
        "import tests.torch_dist_worker\n"
        "import deepspeed_tpu_torch.runtime.activation_checkpointing."
        "checkpointing\n"
        "import deepspeed_tpu_torch.models.simple\n"
        "import deepspeed_tpu_torch.models.cifar\n"
        "import deepspeed_tpu_torch.runtime.checkpoint_io\n"
        "import deepspeed_tpu_torch.runtime.async_checkpoint\n"
        "import deepspeed_tpu_torch.utils.zero_to_fp32\n"
        "import deepspeed_tpu_torch.zero\n"
        "import deepspeed_tpu_torch.runtime.zero.offload\n"
        "import deepspeed_tpu_torch.runtime.swap_tensor.swapper\n"
        "import deepspeed_tpu_torch.ops.adagrad.cpu_adagrad\n"
        "import deepspeed_tpu_torch.telemetry.sinks\n"
        "import deepspeed_tpu_torch.telemetry.manager\n"
        "import deepspeed_tpu_torch.telemetry.slo\n"
        "import deepspeed_tpu_torch.telemetry.obs_server\n"
        "import deepspeed_tpu_torch.runtime.guardian\n"
        "import deepspeed_tpu_torch.monitor.monitor\n"
        "import deepspeed_tpu_torch.utils.timer\n"
        "import deepspeed_tpu_torch.testing.chaos\n"
        "import deepspeed_tpu_torch.ops.transformer.rotary\n"
        "import deepspeed_tpu_torch.models.gptj\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'deepspeed_tpu', 'triton')\n"
        "       or m == 'torch.utils.cpp_extension']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt2.PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2.GPT2LMHeadModel(cfg)
    model = gpt2.GPT2LMHeadModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_inference(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_serving(model=model)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config={
            "train_batch_size": 2})
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt2.synthetic_batch(1, 4, 10)
    assert _platform.resolve_device("cpu").type == "cpu"


def test_bert_entry_points_raise_without_cuda(monkeypatch):
    from deepspeed_tpu_torch.models import bert
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bert.BertForPreTraining(bert.PRESETS["tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bert.synthetic_mlm_batch(1, 4, 10)
    sparse = dataclasses.replace(bert.PRESETS["tiny"],
                                 sparse_attention_mode="fixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        bert.BertForPreTraining(sparse)
    model = bert.BertForPreTraining(sparse, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config={
            "train_batch_size": 2})


def test_loop_entry_points_raise_without_cuda(monkeypatch):
    """The fixture models, the CIFAR net and init_distributed's default
    nccl backend need the card unless the CPU is asked for."""
    from deepspeed_tpu_torch.models import cifar, simple
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: simple.SimpleModel(4), lambda: simple.LinearStack(),
                 lambda: simple.EmbeddingModel(8, 4), cifar.CifarNet,
                 lambda: simple.sample_batch(1, 4),
                 lambda: cifar.synthetic_cifar_batch(1),
                 deepspeed_tpu_torch.init_distributed):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert not torch.distributed.is_initialized()
    simple.SimpleModel(4, device="cpu")


def test_kernel_route_follows_tensor_device(monkeypatch):
    """CPU tensors take the plain versions and never build a kernel; no
    switch of any kind selects the route."""
    def no_build(*a, **k):
        raise AssertionError("a CPU call must not build the kernels")
    monkeypatch.setattr(op_builder, "load_kernels", no_build)
    op_builder.reset_launch_counts()
    q = torch.randn(1, 2, 8, 16)
    o, lse = flash.flash_attention_fwd(q, q, q)
    flash.flash_attention_bwd(q, q, q, o, lse, q)
    decode.decode_attention(q[:, :, :1], q, q, 5)
    x = torch.randn(fused_adam.sweep_pad())
    fused_adam.adam_sweep_apply(None, x, x, x.abs(), 1e-3, 0.1, 0.001, 0.5)
    fused_adam.fused_adam_update(q, q, q, q.abs(), 1e-3, 0.1, 0.001)
    g, b = torch.ones(16), torch.zeros(16)
    y, mu, rstd = fused.layer_norm_fwd(q, g, b, 1e-5)
    fused.layer_norm_bwd(q, g, mu, rstd, q)
    fused.bias_gelu(q, b)
    fused_lamb.lamb_pass1([q], [q], [q], [q.abs()], 0.1, 0.001)
    fused.fused_softmax(q, 0.5)
    quantizer.quantize(q, 4, 2, stochastic=True, seed=1)
    quantizer.quantize(q[0, 0], 8, 2, transposed=True, out=q[0, 0].clone())
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert _platform.use_kernel(q) is False
    with pytest.raises(ValueError, match="one device"):
        _platform.use_kernel(q, q.to("meta"))


def test_op_builder_targets_hopper():
    assert "-gencode=arch=compute_90a,code=sm_90a" in op_builder.NVCC_FLAGS
    for src in op_builder.SOURCES:
        assert (ROOT / "deepspeed_tpu_torch" / "csrc" / src).is_file()
    # the build directory is ignored by git
    assert "/build/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    proc = subprocess.run([sys.executable, "-c",
                           "import sys, torch, runpy\n"
                           "torch.cuda.is_available = lambda: False\n"
                           "sys.argv = ['chip_smoke.py']\n"
                           "runpy.run_path('chip_smoke.py', "
                           "run_name='__main__')\n"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_zero_to_fp32_runs_as_a_module(tmp_path):
    """``python -m deepspeed_tpu_torch.utils.zero_to_fp32`` as the JAX
    module runs, on a tag of the port's engine, without jax."""
    from deepspeed_tpu_torch.models import simple
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=simple.SimpleModel(8, nlayers=2, device="cpu"), device="cpu",
        config={"train_batch_size": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    engine.save_checkpoint(str(tmp_path / "ck"))
    code = (
        "import sys, importlib.abc, runpy\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'flax', 'deepspeed_tpu'):\n"
        "            raise ImportError('port imported ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.argv = ['zero_to_fp32', sys.argv[1], sys.argv[2]]\n"
        "runpy.run_module('deepspeed_tpu_torch.utils.zero_to_fp32', "
        "run_name='__main__')\n")
    out = tmp_path / "fp32.pkl"
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ck"),
                           str(out)], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "saved 4 tensors" in proc.stdout and out.is_file()
