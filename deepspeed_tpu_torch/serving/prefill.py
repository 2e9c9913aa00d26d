"""Chunked prefill — fill a prompt's KV in fixed-size slices
(counterpart of ``deepspeed_tpu/serving/prefill.py``).

A synchronous full-prompt prefill stalls every running request for the
whole prompt forward (hundreds of tokens of compute between two decode
steps). Chunking bounds that stall: each scheduler iteration advances the
prefilling request by at most ``chunk_size`` tokens, interleaved with the
decode batch (Sarathi-style chunked prefill; the scheduler picks at most
one chunk per iteration).

One program signature serves every chunk: chunks are always
``chunk_size`` wide, the final partial chunk is padded, and the pad positions write to
the null block (``n_valid`` masks them). The planner covers
``prompt[:-1]`` only — the last prompt token is the request's first
decode input, so its KV is written by the decode step that samples the
first generated token (TTFT therefore includes exactly one decode step
after the last chunk).

Prefix-cache composition: admission may pre-set ``cached_len`` past 0
when whole prompt blocks were matched read-only from the prefix index
(scheduler ``_admit``). ``remaining`` then naturally plans chunks from
the first uncached token — a fully-cached prefix needs ZERO chunk
dispatches here, just the block-table copy the scheduler already did.
"""

import numpy as np


class ChunkedPrefill:
    def __init__(self, prefill_fn, chunk_size: int):
        """``prefill_fn``: the runner's ``prefill_chunk`` (the server
        passes its compile-watch-wrapped form so chunk signatures are
        tracked)."""
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.prefill_fn = prefill_fn
        self.chunk_size = int(chunk_size)

    def remaining(self, req) -> int:
        """Prompt tokens still to cache (prefill target is P-1)."""
        return max(0, len(req.full_prompt) - 1 - req.cached_len)

    def next_chunk(self, req):
        """Plan the next chunk: ``(tokens[C] int32, start, n_valid)``,
        tokens null-padded to the fixed chunk width."""
        start = req.cached_len
        todo = self.remaining(req)
        n_valid = min(self.chunk_size, todo)
        if n_valid <= 0:
            raise ValueError("next_chunk on a fully prefilled request")
        tokens = np.zeros((self.chunk_size,), np.int64)
        tokens[:n_valid] = req.full_prompt[start:start + n_valid]
        return tokens, start, n_valid

    def run(self, req, max_blocks: int):
        """Execute one chunk for *req* (the pools are written in place);
        returns ``(n_valid, n_recompute, done)`` where ``done`` means the prompt KV is
        complete and the request is decode-ready. ``n_recompute`` counts
        the chunk's tokens below the request's eviction high-water mark
        — positions whose KV existed before a preemption threw it away,
        i.e. compute this chunk is paying a SECOND time (the slot-step
        ledger and ``serving_recompute_tokens_total`` book preemption
        cost from it)."""
        tokens, start, n_valid = self.next_chunk(req)
        bt_row = np.zeros((max_blocks,), np.int64)
        bt_row[:len(req.block_table)] = req.block_table
        self.prefill_fn(bt_row, tokens, np.int32(start), np.int32(n_valid))
        req.cached_len += n_valid
        n_recompute = max(0, min(start + n_valid,
                                 getattr(req, "max_cached_len", 0)) - start)
        return n_valid, n_recompute, self.remaining(req) == 0
