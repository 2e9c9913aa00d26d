"""Block-sparsity layout generators (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``).

A layout is an int tensor ``[num_heads, num_blocks, num_blocks]`` marking
which (query block, key block) tiles attend. This is the JAX package's
numpy index algebra, copied: that module is pure numpy, but it sits in a
package whose import loads jax, so the port keeps its own copy. The
Variable and BigBird configs draw from Python's ``random``, so with
``random.seed(n)`` before each call both packages give the same layout.
"""

import random

import numpy as np


class SparsityConfig:
    """Base: block size + head layout sharing (reference :25)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks),
                        dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend (reference :63): the degenerate oracle config."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local+global pattern (reference :94): local windows of
    ``num_local_blocks``; the last ``num_global_blocks`` of each window
    attend globally; 'unidirectional' restricts to the causal half."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention requires bidirectional")
        self.horizontal_global_attention = horizontal_global_attention
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be a multiple "
                f"of num_global_blocks {num_global_blocks}")
        self.num_global_blocks = num_global_blocks
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "different global patterns require different_layout_per_head")
        max_patterns = num_local_blocks // num_global_blocks
        if num_different_global_patterns > max_patterns:
            raise ValueError(
                f"num_different_global_patterns "
                f"{num_different_global_patterns} exceeds "
                f"num_local/num_global {max_patterns}")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        for i in range(0, num_blocks, self.num_local_blocks):
            end = min(i + self.num_local_blocks, num_blocks)
            for row in range(i, end):
                for col in range(i, (row + 1 if self.attention ==
                                     "unidirectional" else end)):
                    layout[h, row, col] = 1
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        first_global_block_idx = (
            self.num_local_blocks - (1 + h % self.num_different_global_patterns)
            * self.num_global_blocks)

        end_block_idx = num_blocks if self.attention == "bidirectional" else \
            num_blocks  # causal masking handled per row below
        for i in range(first_global_block_idx, num_blocks,
                       self.num_local_blocks):
            # vertical global columns
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.attention == "unidirectional":
                # zero the upper triangle the vertical stripe created
                for row in range(num_blocks):
                    for col in range(i, min(i + self.num_global_blocks,
                                            num_blocks)):
                        if col > row:
                            layout[h, row, col] = 0
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local windows + random + custom global blocks
    (reference :243)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention requires bidirectional")
        self.horizontal_global_attention = horizontal_global_attention
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices "
                    "must have equal length")
        self.global_block_end_indices = global_block_end_indices

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"num_random_blocks {self.num_random_blocks} exceeds "
                f"{num_blocks}")
        for row in range(num_blocks):
            sample = random.sample(range(num_blocks), self.num_random_blocks)
            if self.attention == "unidirectional":
                sample = [s for s in sample if s <= row]
            layout[h, row, sample] = 1
        return layout

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        start = 0
        while start < num_blocks:
            for w in self.local_window_blocks:
                end = min(start + w, num_blocks)
                for row in range(start, end):
                    for col in range(start, (row + 1 if self.attention ==
                                             "unidirectional" else end)):
                        layout[h, row, col] = 1
                start = end
                if start >= num_blocks:
                    break
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx >= num_blocks:
                    continue
                first_row = 0 if self.attention == "bidirectional" else idx
                layout[h, first_row:, idx] = 1
                if self.horizontal_global_attention:
                    layout[h, idx, :] = 1
        else:
            for start, end in zip(self.global_block_indices,
                                  self.global_block_end_indices):
                end = min(end, num_blocks)
                first_row = 0 if self.attention == "bidirectional" else start
                layout[h, first_row:, start:end] = 1
                if self.horizontal_global_attention:
                    layout[h, start:end, :] = 1
        if self.attention == "unidirectional":
            tri = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout[h] &= tri
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding window + global (reference :421)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention}")
        self.attention = attention

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        for row in range(num_blocks):
            hi = (row + 1) if self.attention == "unidirectional" \
                else num_blocks
            n = min(self.num_random_blocks, hi)
            sample = random.sample(range(hi), n)
            layout[h, row, sample] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for row in range(num_blocks):
            lo = max(0, row - w)
            hi = min(row + w + 1, num_blocks)
            if self.attention == "unidirectional":
                hi = min(hi, row + 1)
            layout[h, row, lo:hi] = 1
        return layout

    def set_global_layout_itc(self, h, layout):
        num_blocks = layout.shape[1]
        g = min(self.num_global_blocks, num_blocks)
        layout[h, 0:g, :] = 1
        layout[h, :, 0:g] = 1
        if self.attention == "unidirectional":
            tri = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout[h] &= tri
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + symmetric global attention (reference :544)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        if global_block_end_indices is not None and \
                len(self.global_block_indices) != len(global_block_end_indices):
            raise ValueError("index list lengths must match")

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for row in range(num_blocks):
            lo = max(0, row - w)
            hi = min(row + w + 1, num_blocks)
            if self.attention == "unidirectional":
                hi = min(hi, row + 1)
            layout[h, row, lo:hi] = 1
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start, end in spans:
            end = min(end, num_blocks)
            layout[h, :, start:end] = 1
            layout[h, start:end, :] = 1
        if self.attention == "unidirectional":
            tri = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout[h] &= tri
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
