"""The PyTorch port's grouped quantizer (``ops/quantizer/quantizer.py``)
against the JAX package's.

On the CPU the JAX ``quantize`` takes its fallback path, ``_quantize_rows``
over ``[groups, row]``: the same math as its Pallas kernel body
(quantizer.py:76). The port's wrapper runs its plain version on CPU
tensors. Inputs come from a numpy seed. Tolerances: atol 0 everywhere —
both sides compute in fp32 with IEEE divisions, round half to even (or
floor(q + noise)), and round the result once to the input dtype, so they
agree bit for bit. Stochastic rounding is compared with the same noise
injected into both ``_quantize_rows`` (the TPU kernel draws from the TPU
generator, the port from Philox); the port's own Philox draw is held to a
reference implementation in Python integers. The CUDA kernel is held
against the plain version in tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import quantizer as jax_quantizer
from deepspeed_tpu_torch.ops.quantizer import quantizer

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _x(shape, seed, zero_row=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    if zero_row:
        x.reshape(8, -1)[3] = 0.0   # a zero group when groups = 8
    return x


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("groups", [1, 8])
@pytest.mark.parametrize("bits", [2, 3, 4, 8, 12, 16])
def test_quantize_matches_jax(dtype, symmetric, groups, bits):
    x = _x((16, 24), seed=bits * 10 + groups)
    want = jax_quantizer.quantize(jnp.asarray(x, JDT[dtype]), bits, groups,
                                  symmetric, False)
    got = quantizer.quantize(torch.from_numpy(x).to(TDT[dtype]), bits,
                             groups, symmetric)
    assert got.dtype == TDT[dtype] and got.shape == (16, 24)
    np.testing.assert_array_equal(_np(got), _np(want.astype(jnp.float32)))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("groups", [1, 8, 16])
def test_transposed_layout_groups_the_reference_layout(symmetric, groups):
    """An [out, in] tensor quantized with ``transposed=True`` equals the
    JAX quantizer over the flax [in, out] layout, transposed back (with
    groups 16 a group ends inside a flax row of 40)."""
    x = _x((24, 40), seed=groups, zero_row=False)    # flax [in, out]
    want = jax_quantizer.quantize(jnp.asarray(x), 4, groups, symmetric,
                                  False)
    got = quantizer.quantize(torch.from_numpy(x.T.copy()), 4, groups,
                             symmetric, transposed=True)
    np.testing.assert_array_equal(_np(got).T, _np(want))
    if groups > 1:   # grouping the buffer as it lies gives other scales
        naive = quantizer.quantize(torch.from_numpy(x.T.copy()), 4, groups,
                                   symmetric)
        assert not np.array_equal(_np(naive).T, _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stochastic_rows_match_jax_with_injected_noise(dtype, symmetric,
                                                       bits):
    x = _x((8, 96), seed=bits)
    noise = np.random.default_rng(bits + 1).random((8, 96)).astype(
        np.float32)
    want = jax_quantizer._quantize_rows(jnp.asarray(x, JDT[dtype]), bits,
                                        symmetric, True, jnp.asarray(noise))
    got = quantizer._quantize_rows(torch.from_numpy(x).to(TDT[dtype]), bits,
                                   symmetric, True, torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def _philox_reference(seed, index):
    """Philox4x32-10, first word, in Python integers."""
    m0, m1, w0, w1, mask = (0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85,
                            0xFFFFFFFF)
    c = [index & mask, index >> 32, 0, 0]
    k = [seed & mask, (seed >> 32) & mask]
    for r in range(10):
        if r:
            k = [(k[0] + w0) & mask, (k[1] + w1) & mask]
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & mask, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & mask]
    return c[0]


@pytest.mark.parametrize("seed", [0, 1, 2 ** 40 + 12345])
def test_philox_matches_reference(seed):
    index = [0, 1, 2, 255, 123456789, 2 ** 32 - 1, 2 ** 32 + 7, 2 ** 45 + 3]
    want = np.array([(_philox_reference(seed, i) >> 8) / 2 ** 24
                     for i in index])
    got = quantizer.philox_uniform(seed, torch.tensor(index)).double()
    np.testing.assert_array_equal(got.numpy(), want)
    # Random123's known answer for a zero counter and key
    assert _philox_reference(0, 0) == 0x6627E8D5


def test_stochastic_quantize_is_deterministic_per_seed():
    x = torch.from_numpy(_x((8, 64), seed=3))
    a = quantizer.quantize(x, 4, 8, stochastic=True, seed=7)
    b = quantizer.quantize(x, 4, 8, stochastic=True, seed=7)
    c = quantizer.quantize(x, 4, 8, stochastic=True, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        quantizer.quantize(x, 4, 8, stochastic=True)


# -- the cases of tests/unit/test_quantizer.py ------------------------------

def test_symmetric_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 256)).astype(np.float32))
    y = quantizer.quantize(x, num_bits=8, groups=4)
    step = x.reshape(4, -1).abs().amax(-1, keepdim=True) / 127
    assert ((y - x).reshape(4, -1).abs() <= step / 2 + 1e-6).all()


def test_asymmetric_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 512)).astype(np.float32))
    y = quantizer.quantize(x, num_bits=8, groups=2, symmetric=False)
    xg = x.reshape(2, -1)
    step = (xg.amax(-1, keepdim=True) - xg.amin(-1, keepdim=True)) / 255
    assert ((y - x).reshape(2, -1).abs() <= step / 2 + 1e-6).all()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_levels(bits):
    x = torch.linspace(-1, 1, 1024)
    y = quantizer.quantize(x, num_bits=bits, groups=1)
    assert torch.unique(y).numel() <= 2 ** bits


def test_stochastic_rounding_unbiased():
    x = torch.full((1, 8192), 0.3)
    x[0, 0] = 1.0                         # scale 1/7 at 4 bits
    ys = torch.stack([quantizer.quantize(x, 4, 1, stochastic=True, seed=s)
                      for s in range(64)])
    # 64 · 8191 draws of a value 2.1 steps above a level: the mean of the
    # rounding lands within 1e-3 of 0.3
    assert abs(ys[:, 0, 1:].mean().item() - 0.3) < 1e-3


def test_zero_input_stable():
    for symmetric in (True, False):
        y = quantizer.quantize(torch.zeros(4, 32), 8, 4, symmetric)
        assert torch.equal(y, torch.zeros(4, 32))


def test_out_writes_in_place_and_shell_owns_its_seed():
    x = torch.from_numpy(_x((8, 32), seed=5))
    want = quantizer.quantize(x, 8, 8)
    y = x.clone()
    assert quantizer.quantize(y, 8, 8, out=y) is y
    assert torch.equal(y, want)
    shell = quantizer.Quantizer()
    assert shell.num_bits == 8 and quantizer.Quantizer(False).num_bits == 16
    a = shell.quantize(x, 8, stochastic=True)
    b = shell.quantize(x, 8, stochastic=True)
    assert shell._seed == 2 and not torch.equal(a, b)


def test_quantize_rejects_bad_arguments():
    x = torch.zeros(6, 5)
    with pytest.raises(ValueError, match="divisible"):
        quantizer.quantize(x, 8, 4)
    with pytest.raises(ValueError, match="num_bits"):
        quantizer.quantize(x, 0, 1)
    with pytest.raises(ValueError, match="2-D"):
        quantizer.quantize(torch.zeros(2, 3, 4), 8, 1, transposed=True)


# -- the multi-tensor call (one launch a MoQ step on the card) -------------

# (shape, groups, stored [out, in], dtype, bits): fp32 and bf16, groups
# 1/7/8/16, ragged rows (77), [out, in] strips, a group that ends inside a
# reference row (24 columns, 16 groups)
MIXED = [((16, 24), 8, False, "float32", 8),
         ((63, 77), 7, False, "bfloat16", 4),
         ((24, 40), 8, True, "float32", 10),
         ((40, 24), 16, True, "bfloat16", 8),
         ((21, 8), 1, True, "float32", 4),
         ((32, 64), 1, False, "bfloat16", 10)]


def _mixed_list():
    return [torch.from_numpy(_x(shape, seed=i, zero_row=False)).to(TDT[dt])
            for i, (shape, _, _, dt, _) in enumerate(MIXED)]


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_multi_plain_matches_per_tensor_and_jax(symmetric,
                                                         stochastic):
    """``quantize_multi_plain`` (and ``quantize_multi`` on CPU tensors)
    equals ``quantize_plain`` on each tensor of a mixed list, and the JAX
    ``quantize`` over the flax layout for nearest rounding."""
    xs = _mixed_list()
    kw = dict(num_bits=[b for *_, b in MIXED],
              groups=[g for _, g, *_ in MIXED], symmetric=symmetric,
              stochastic=stochastic, seeds=[11 * i + 3 for i in
                                            range(len(MIXED))],
              transposed=[tr for _, _, tr, *_ in MIXED])
    got = quantizer.quantize_multi_plain(xs, **kw)
    assert [g.dtype for g in got] == [x.dtype for x in xs]
    for y, other in zip(got, quantizer.quantize_multi(xs, **kw)):
        assert torch.equal(y, other)
    for i, (x, y) in enumerate(zip(xs, got)):
        _, g, tr, dt, b = MIXED[i]
        want = quantizer.quantize_plain(x, b, g, symmetric, stochastic,
                                        kw["seeds"][i], tr)
        assert torch.equal(y, want), i
        if stochastic:
            continue
        ref = (x.t() if tr else x).float().numpy()
        jwant = jax_quantizer.quantize(jnp.asarray(ref, JDT[dt]), b, g,
                                       symmetric, False)
        jwant = np.asarray(jwant.astype(jnp.float32))
        np.testing.assert_array_equal(_np(y.t() if tr else y), jwant,
                                      err_msg=str(i))


def test_quantize_multi_writes_out_and_checks_its_arguments():
    xs = _mixed_list()[:3]
    ys = [x.clone() for x in xs]
    want = quantizer.quantize_multi_plain(xs, 8, [8, 7, 8],
                                          transposed=[False, False, True])
    got = quantizer.quantize_multi(ys, 8, [8, 7, 8],
                                   transposed=[False, False, True], out=ys)
    assert all(g is y for g, y in zip(got, ys))
    assert all(torch.equal(y, w) for y, w in zip(ys, want))
    with pytest.raises(ValueError, match="groups"):
        quantizer.quantize_multi(xs, 8, [8, 7])
    with pytest.raises(ValueError, match="out"):
        quantizer.quantize_multi(xs, 8, 1, out=ys[:2])
    assert quantizer.quantize_multi([], 8) == []


def _entries(rows):
    """The kernel's per-entry numbers (ds_quantize_multi): group length,
    chunks a group, first chunk, first group, strip width."""
    out, chunk, group = [], 0, 0
    for n, g, R, C, flags in rows[:, [2, 3, 4, 5, 7]]:
        L = n // g
        cpg = -(-L // quantizer.CHUNK)
        out.append(dict(L=L, cpg=cpg, chunk0=chunk, group0=group, g=g,
                        R=R, C=C, tr=bool(flags & 2),
                        w=C // g if flags & 2 else 1))
        chunk += g * cpg
        group += g
    return out


def _thread_walk(j0, j1, w, W, threads=256):
    """(j, row, col) of every vector the kernel's threads visit in
    [j0, j1) of a strip of width w, stepping row and column counters as
    the kernel's ``Walk`` does (no division in the loop)."""
    step = threads * W
    drow, dcol = divmod(step, w)
    out = []
    for t in range(threads):
        j = j0 + t * W
        row, col = divmod(j, w)
        while j < j1:
            out.append((j, row, col))
            row, col = row + drow, col + dcol
            if col >= w:
                row, col = row + 1, col - w
            j += step
    return out


def _cover(plan, specs):
    """Every element of every tensor visited exactly once over the plan's
    kernel calls, each at its place in the reference layout and in its
    own group; each call's scratch sized by its chunks and groups."""
    seen = [np.zeros(n, int) for n, *_ in specs]
    for first, stop, partial, scale, count, chunks, groups in plan.calls:
        ents = _entries(plan.rows[first:stop])
        chunk0 = [e["chunk0"] for e in ents]
        assert chunks == sum(e["g"] * e["cpg"] for e in ents)
        assert groups == sum(e["g"] for e in ents)
        assert partial.numel() == 2 * chunks and scale.numel() == 2 * groups
        assert count.numel() == groups and not count.any()
        for c in range(chunks):
            i = int(np.searchsorted(chunk0, c, "right")) - 1
            e = ents[i]
            g, k = divmod(c - e["chunk0"], e["cpg"])
            j0 = k * quantizer.CHUNK
            j1 = min(e["L"], j0 + quantizer.CHUNK)
            j = np.arange(j0, j1)
            if e["tr"]:
                row, col = j // e["w"], j % e["w"]
                phys = row * e["C"] + g * e["w"] + col
                ref = (g * e["w"] + col) * e["R"] + row
            else:
                phys = ref = g * e["L"] + j
            assert (ref // e["L"] == g).all()     # the group's own elements
            seen[first + i][phys] += 1
    assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize("case", ["small_groups", "one_large_group",
                                  "strips_and_ragged_chunks",
                                  "bf16_and_fp32"])
def test_plan_covers_every_element_once(case):
    """The host plan (``_MultiPlan``: table rows, chunks, scratch) walked
    as the kernels walk it: each element of each tensor exactly once, in
    its own group, at its reference index."""
    f32, b16 = torch.float32, torch.bfloat16
    # (numel, groups, dtype, transposed, R, C)
    specs = {
        "small_groups": [(512, 8, f32, False, 0, 0)] * 5
        + [(96, 3, f32, False, 0, 0)],
        "one_large_group": [(1024, 2, f32, False, 0, 0),
                            (70000, 1, f32, False, 0, 0),
                            (2048, 8, f32, False, 0, 0)],
        "strips_and_ragged_chunks": [(600 * 24, 8, f32, True, 600, 24),
                                     (40000 * 8, 8, f32, False, 0, 0),
                                     (50 * 128, 8, f32, True, 50, 128),
                                     (4000 * 64, 2, f32, True, 4000, 64)],
        "bf16_and_fp32": [(4096 * 3, 3, b16, False, 0, 0),
                          (300 * 40, 8, b16, True, 300, 40),
                          (8192, 2, f32, False, 0, 0)]}[case]
    sig = tuple((n, g, dt, tr, R, C, False) for n, g, dt, tr, R, C in specs)
    plan = quantizer._MultiPlan(sig, "cpu")
    assert len(plan.calls) == 1
    _cover(plan, [(n, g) for n, g, *_ in specs])
    rows = plan.rows
    assert (rows[:, 7] & 2 != 0).tolist() == [s[3] for s in specs]
    assert (rows[:, 7] & 1 != 0).tolist() == [s[2] == b16 for s in specs]


def test_plan_splits_past_the_table():
    """More tensors than a call's table holds go in several calls;
    BERT-large's word embeddings (3.9 M elements a group) and qkv weights
    are cut into chunks as the kernels number them."""
    specs = [(64, 2)] * 700
    assert [(a, b) for a, b, *_ in quantizer.plan_calls(specs)] == [
        (0, 320), (320, 640), (640, 700)]
    assert len(quantizer.plan_calls(specs, max_tensors=3)) == 234
    emb, qkv = (30592 * 1024, 8), (3072 * 1024, 8)
    (first, stop, chunks, groups), = quantizer.plan_calls([emb, qkv, qkv])
    cpg = [-(-(n // 8) // quantizer.CHUNK) for n, _ in (emb, qkv)]
    assert (first, stop, groups) == (0, 3, 24)
    assert chunks == 8 * cpg[0] + 16 * cpg[1]


@pytest.mark.parametrize("w,W", [(24, 4), (128, 4), (40, 8), (9, 1),
                                 (512, 4), (1000, 8)])
def test_strip_walk_counters_match_division(w, W):
    """The kernel's row and column counters over a strip give the rows and
    columns a division would, for strips narrower and wider than a block's
    step."""
    for j0, j1 in ((0, 4096), (4096, 8192), (8192, 9000)):
        j0, j1 = j0 - j0 % W, j1 - j1 % W
        for j, row, col in _thread_walk(j0, j1, w, W):
            assert (row, col) == divmod(j, w)
