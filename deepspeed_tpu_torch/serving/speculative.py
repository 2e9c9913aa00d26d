"""Speculative decoding over the paged + prefix-cached KV (counterpart of
``deepspeed_tpu/serving/speculative.py``).

A cheap draft proposes ``k`` greedy tokens, then the target scores all
``k+1`` positions in ONE forward and keeps the longest prefix it agrees
with:

* ``draft_step`` — ``k`` greedy steps through the DRAFT: by default the
  truncated-layer self-draft (the target's first ``draft_layers`` layers
  plus its ``ln_f`` and tied head, whose K/V equal the target's, so the
  draft's writes land in the same pools), or an explicit small model
  (``draft_params``, a GPT-2 ``state_dict``). Draft quality moves only the
  acceptance rate.
* ``verify_step`` — the target over ``k+1`` positions per slot: past
  pages through ``paged_verify_attention`` (or the gather impl's dense
  masked attention), the candidates in registers, then one store of
  every layer's K/V at every candidate position. Target tokens come from
  the same ``sample_tokens`` and position schedule as plain decoding, so
  greedy verification is argmax for argmax the sequential program.

The drafted tokens stay on the device between the two programs: one host
sync a dispatch, as plain decoding. Rejection is a state edit: the host
does not advance ``cached_len`` past the accepted prefix; rejected
positions keep stale bytes that every read masks until they are
overwritten.

Acceptance: ``"exact"`` accepts a draft iff it equals the target's own
token (equal outputs to the non-speculative engine, greedy and sampled);
``"typical"`` accepts a sampled slot's draft whose target probability
clears ``typical_threshold`` × the modal probability (greedy slots stay
exact).
"""

import numpy as np
import torch

from deepspeed_tpu_torch.serving.paged_attention import \
    paged_verify_attention
from deepspeed_tpu_torch.serving.runner import (NEG_INF, GPT2Weights, _dense,
                                                _head, _ln)
from deepspeed_tpu_torch.serving.sampling import sample_tokens


def default_draft_layers(n_layer: int) -> int:
    """Self-draft depth when the config leaves ``draft_layers`` at 0: a
    quarter of the stack (floor 1)."""
    return max(1, int(n_layer) // 4)


def validate_draft_params(params, target_params, n_layers: int):
    """An explicit draft (a GPT-2 ``state_dict``) must share the target's
    embedding width (its K/V land in the target's pools) and vocab rows
    (its argmax is compared with target tokens), and hold ``n_layers``
    blocks plus the exit pieces."""
    for key in ("wte", "wpe", "ln_f.weight", "ln_f.bias"):
        if key not in params:
            raise ValueError(f"draft params missing {key!r}")
    if tuple(params["wte"].shape) != tuple(target_params["wte"].shape):
        raise ValueError(
            f"draft wte {tuple(params['wte'].shape)} != target "
            f"{tuple(target_params['wte'].shape)}: the draft must share "
            f"the target's vocab and embedding width")
    for layer in range(n_layers):
        if f"h.{layer}.attn.qkv.weight" not in params:
            raise ValueError(f"draft params has no h.{layer} but "
                             f"draft_layers={n_layers}")


class SpeculativeDecoder:
    """The draft and verify programs and the acceptance rule. Holds no
    per-request state: rollback is the server not advancing
    ``cached_len``."""

    def __init__(self, runner, *, k, draft_layers=0, acceptance="exact",
                 typical_threshold=0.3, draft_params=None):
        if k < 1:
            raise ValueError(f"speculative k must be >= 1, got {k}")
        if acceptance not in ("exact", "typical"):
            raise ValueError(f"acceptance must be 'exact' or 'typical', "
                             f"got {acceptance!r}")
        self.runner = runner
        self.k = int(k)
        L = runner.cfg.n_layer
        self.draft_layers = (int(draft_layers) if draft_layers
                             else default_draft_layers(L))
        if draft_params is None and not 1 <= self.draft_layers <= L:
            raise ValueError(f"self-draft draft_layers={self.draft_layers} "
                             f"must be in [1, n_layer={L}]")
        self.acceptance = acceptance
        self.typical_threshold = float(typical_threshold)
        self.draft_params = draft_params
        self.draft_weights = (None if draft_params is None else
                              GPT2Weights(draft_params, self.draft_layers))

    # ----------------------------------------------------------- draft
    def draft_step(self, bt, pos, active, tok, budget):
        """``k`` greedy steps through the draft (host numpy inputs as
        ``PagedGPT2Runner.decode_step``); its writes are budget-masked to
        the null block past each slot's allocation. Returns the drafted
        tokens ``[k, B]`` int64 on the device."""
        r = self.runner
        B = len(pos)
        vocab = r.cfg.vocab_size
        cur = None
        out = []
        for i in range(self.k):
            step_pos = pos + np.minimum(i, np.maximum(budget - 1, 0))
            live = active & (i < budget)
            ints = r.upload(r.step_inputs(tok, step_pos, live, bt))
            s = r.unpack(ints, B)
            if cur is not None:
                s["tok"].copy_(cur)
            logits = r.stack_decode(
                ints, B, n_layers=self.draft_layers,
                weights=self.draft_weights,
                n_blocks=r.n_blocks_for(step_pos))
            nxt = torch.argmax(logits[:, :vocab], dim=-1)
            cur = torch.where(s["live"] != 0, nxt, s["tok"])
            out.append(nxt)
        return torch.stack(out)

    # ---------------------------------------------------------- verify
    def _attn_verify(self, lp, layer, x, bt, pos_d, poss, blk, off,
                     n_blocks):
        """One layer's attention for the k+1 candidates of every slot.
        Paged: past pages + the chunk from registers (the store comes
        after the stack). Gather: write, then dense per-query masked
        attention over each slot's view."""
        r = self.runner
        B, C = poss.shape
        H, D = r.n_head, r.head_dim
        N, E = x.shape
        q, k, v = r._qkv(lp, x)                         # [B*C, H, D]

        def heads(t):                                   # -> [B, H, C, D]
            return t.reshape(B, C, H, D).transpose(1, 2)

        kp, vp, ksp, vsp = r._pools()
        if r.attention_impl == "paged":
            out = paged_verify_attention(
                heads(q), heads(r._requant(k)), heads(r._requant(v)),
                layer, kp, vp, bt, pos_d, n_blocks=n_blocks,
                k_scale_pool=ksp, v_scale_pool=vsp)
            out = out.transpose(1, 2).reshape(N, E).to(x.dtype)
            return _dense(out, lp.proj), (k, v)
        r.cache.write_decode(layer, k, v, blk, off)
        kg, vg, ksg, vsg = r.cache.gather(layer, bt)    # [B, H, T, D]
        if ksg is not None:
            kg = (kg.float() * ksg[..., None]).to(x.dtype)
            vg = (vg.float() * vsg[..., None]).to(x.dtype)
        T = kg.shape[2]
        scores = (heads(q).float() @ kg.float().transpose(-1, -2)) \
            * D ** -0.5
        mask = torch.arange(T, device=x.device)[None, None, :] \
            <= poss[:, :, None]                         # [B, C, T]
        probs = torch.softmax(torch.where(mask[:, None], scores, NEG_INF),
                              dim=-1)
        out = probs.to(vg.dtype) @ vg
        out = out.transpose(1, 2).reshape(N, E).to(x.dtype)
        return _dense(out, lp.proj), None

    def verify_step(self, bt, pos, active, drafted, tok, temp, top_p,
                    lanes, budget):
        """ONE target forward over k+1 positions per slot; returns
        ``(accepted [B], tokens [k+1, B])`` on the device: row j is the
        j-th delivered token (accepted drafts, then the target's own
        token at the first disagreement). Only ``min(accepted+1,
        budget)`` rows count per slot; the host caps delivery."""
        r = self.runner
        cfg = r.cfg
        bs = r.cache.block_size
        K, C = self.k, self.k + 1
        B, MB = bt.shape
        W = r.weights
        cols = np.arange(C)
        poss = pos[:, None] + cols[None, :]
        live_w = active[:, None] & (cols[None, :] < budget[:, None])
        row = np.take_along_axis(bt, np.minimum(poss // bs, MB - 1), axis=1)
        blk = np.where(live_w, row, 0)
        # the tail candidates of a budget-capped slot can step past
        # n_positions; their rows are write-masked, the clamp keeps the
        # embedding index legal
        pos_emb = np.minimum(poss, cfg.n_positions - 1)
        host = [np.asarray(tok)[:, None], poss, pos_emb, blk, poss % bs,
                np.repeat(lanes, C, axis=0).reshape(B, 2 * C)]
        ints = r.upload(np.concatenate(
            [a.reshape(-1) for a in host]
            + [np.asarray(pos).reshape(-1), bt.reshape(-1)]).astype(
                np.int64))
        n = B * C
        tok_d = ints[:B]
        poss_d, emb_d, blk_d, off_d = ints[B:B + 4 * n].view(4, B, C)
        lanes_d = ints[B + 4 * n:B + 6 * n].view(n, 2)
        pos_d = ints[B + 6 * n:B + 6 * n + B]
        bt_d = ints[B + 6 * n + B:].view(B, MB)
        toks_in = torch.cat([tok_d[:, None], drafted.t()], dim=1)  # [B, C]
        x = (W.wte[toks_in] + W.wpe[emb_d].to(W.wte.dtype)).reshape(
            n, cfg.n_embd)
        n_blocks = r.n_blocks_for(pos)
        ks, vs = [], []
        for layer, lp in enumerate(W.layers):
            a, kv = self._attn_verify(lp, layer, x, bt_d, pos_d, poss_d,
                                      blk_d.reshape(-1), off_d.reshape(-1),
                                      n_blocks)
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
            x = x + a
            x = x + r._mlp(lp, x)
        if ks:
            # accepted positions become the target's KV, rejected ones
            # stale bytes the length masks never read
            r.cache.write_all_layers(torch.stack(ks), torch.stack(vs),
                                     blk_d.reshape(-1), off_d.reshape(-1))
        logits = _head(_ln(x, W.ln_f), W.wte)
        all_greedy = bool(np.all(temp <= 0.0))
        rep = (None, None) if all_greedy else (
            r.upload(np.repeat(np.asarray(temp, np.float32), C)),
            r.upload(np.repeat(np.asarray(top_p, np.float32), C)))
        tgt = sample_tokens(logits, rep[0], rep[1], lanes_d,
                            poss_d.reshape(-1), all_greedy=all_greedy,
                            vocab_size=cfg.vocab_size).reshape(B, C)
        dT = drafted.t()                                 # [B, K]
        match = dT == tgt[:, :K]
        if self.acceptance == "typical" and not all_greedy:
            probs = torch.softmax(
                logits[:, :cfg.vocab_size].reshape(B, C, -1)[:, :K], -1)
            p_draft = torch.gather(probs, -1, dT[..., None])[..., 0]
            typical = p_draft >= self.typical_threshold \
                * probs.amax(dim=-1)
            sampled = r.upload(np.asarray(temp, np.float32) > 0.0)
            match = torch.where(sampled[:, None], typical, match)
        accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
        cols_d = torch.arange(C, device=x.device)[None, :]
        padded = torch.cat([dT, torch.zeros_like(dT[:, :1])], dim=1)
        out = torch.where(cols_d < accepted[:, None], padded, tgt)
        return accepted, out.t()
