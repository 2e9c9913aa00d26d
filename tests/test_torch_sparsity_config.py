"""The port's copy of the sparsity configs against the JAX package's: every
config gives the same layout at several sequence lengths, uni- and
bidirectional (Variable and BigBird draw from Python's ``random``, seeded
before each call), and raises the same errors."""

import random

import numpy as np
import pytest

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

CASES = [
    ("DenseSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4,
                                 num_global_blocks=2)),
    ("FixedSparsityConfig", dict(block=8, attention="unidirectional")),
    ("FixedSparsityConfig", dict(block=16, horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(block=16, different_layout_per_head=True,
                                 num_different_global_patterns=4)),
    ("FixedSparsityConfig", dict(block=64, num_local_blocks=4,
                                 num_global_blocks=1)),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2,
                                    local_window_blocks=[2, 4])),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=1,
                                    attention="unidirectional",
                                    different_layout_per_head=True)),
    ("VariableSparsityConfig", dict(block=16, global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7],
                                    horizontal_global_attention=True)),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=2)),
    ("BigBirdSparsityConfig", dict(block=8, attention="unidirectional",
                                   different_layout_per_head=True)),
    ("BSLongformerSparsityConfig", dict(block=16)),
    ("BSLongformerSparsityConfig", dict(block=16, global_block_indices=[1, 6],
                                        global_block_end_indices=[3, 7],
                                        attention="unidirectional")),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
@pytest.mark.parametrize("seq", [128, 256, 512])
def test_layouts_equal_jax(name, kw, seq):
    want_cfg = getattr(jsc, name)(num_heads=4, **kw)
    got_cfg = getattr(tsc, name)(num_heads=4, **kw)
    assert vars(got_cfg) == vars(want_cfg)
    random.seed(seq)
    want = want_cfg.make_layout(seq)
    random.seed(seq)
    got = got_cfg.make_layout(seq)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", [
    ("FixedSparsityConfig", dict(attention="sideways")),
    ("FixedSparsityConfig", dict(attention="unidirectional",
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=3)),
    ("FixedSparsityConfig", dict(num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(different_layout_per_head=True,
                                 num_different_global_patterns=8)),
    ("VariableSparsityConfig", dict(attention="sideways")),
    ("VariableSparsityConfig", dict(attention="unidirectional",
                                    horizontal_global_attention=True)),
    ("VariableSparsityConfig", dict(global_block_indices=[0, 1],
                                    global_block_end_indices=[2])),
    ("BigBirdSparsityConfig", dict(attention="sideways")),
    ("BSLongformerSparsityConfig", dict(global_block_indices=[0, 1],
                                        global_block_end_indices=[2])),
])
def test_constructor_errors_equal_jax(name, kw):
    with pytest.raises(Exception) as want:
        getattr(jsc, name)(num_heads=4, **kw)
    with pytest.raises(Exception) as got:
        getattr(tsc, name)(num_heads=4, **kw)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,kw,seq", [
    ("FixedSparsityConfig", dict(block=16), 100),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=9), 128),
    ("SparsityConfig", dict(block=16), 128),
])
def test_layout_errors_equal_jax(name, kw, seq):
    with pytest.raises(Exception) as want:
        getattr(jsc, name)(num_heads=2, **kw).make_layout(seq)
    with pytest.raises(Exception) as got:
        getattr(tsc, name)(num_heads=2, **kw).make_layout(seq)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
