"""Paged model runner — the decode and prefill programs behind the server
(counterpart of ``deepspeed_tpu/serving/runner.py``).

The model's own cached decode keeps one position for the whole batch,
which continuous batching breaks. This runner re-expresses the same
GPT-2 math over the model's weights (its ``state_dict`` tensors) with a
position per slot and the paged pools of serving/kv_cache.py:

* ``decode_step`` — one dispatch of ``decode_steps`` tokens for every
  slot: embed each slot's token at its own position, attend over its
  block table, sample (serving/sampling.py). The ``paged`` impl attends
  over the live blocks (serving/paged_attention.py) and writes every
  layer's K/V after the stack in one store; the ``gather`` impl writes
  each layer's K/V first, gathers the slot's window into the contiguous
  view and runs the decode kernel (``ops/transformer/decode.py``, kernel
  row 7: ``n_layer`` launches a token, fp or int8 KV).
* ``prefill_chunk`` — fills one slot's prompt KV a chunk at a time.

Everything the host knows — positions, live flags, the block and offset
each write goes to, lengths, lanes — is computed in numpy and uploaded
in ONE copy a step (a pinned buffer on CUDA). The only value that flows
from the device into a later step is the previous token.

CUDA graph: on CUDA the ``gather`` impl's one-token stack, from the
embedding to the logits, is captured once per server (at construction)
over a static input buffer and replayed every decode step; sampling runs
after the replay. It is the counterpart of the reference's one jitted
decode program. The capture's kernel launches are added to
``op_builder.LAUNCHES`` on every replay (the capture itself launches
nothing). A capture that fails raises. The ``paged`` impl, whose gather
size follows the live length, runs eagerly.

Weight formats: float weights, and the int8 weights of
``init_inference(dtype=torch.int8)`` (``weight_scale`` buffers beside
them) through ``int8_linear.int8_matmul``. The int8 KV layout is the
cache's concern.
"""

import collections

import numpy as np
import torch
from torch.nn import functional as F

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.quantizer.int8_linear import int8_matmul
from deepspeed_tpu_torch.ops.transformer.decode import (decode_attention,
                                                        quantize_kv)
from deepspeed_tpu_torch.serving.paged_attention import (
    paged_decode_attention, paged_prefill_attention)
from deepspeed_tpu_torch.serving.sampling import NEG_INF, sample_tokens

_LN_EPS = 1e-5
# the packed per-step host inputs: [B] segments, then the [B, MB] table
_SEGMENTS = ("tok", "pos", "emb", "live", "blk", "off", "lens", "lane0",
             "lane1")


def _ln(x, wb):
    """nn.LayerNorm(eps=1e-5) in the JAX runner's fast-variance form:
    var = E[x²] − μ², clamped at 0."""
    w, b = wb
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * w + b


def _dense(x, d):
    """QuantDense parity: float weights ``[out, in]`` through
    ``F.linear``; int8 weights fold their per-output scale in after the
    product."""
    w, b, scale = d
    if w.dtype == torch.int8:
        return int8_matmul(x, w, scale, b)
    return F.linear(x, w, b)


def _head(x, wte):
    """Tied-head logits in fp32: a bf16 x times the bf16 ``wte`` with
    fp32 output on the card (the table is never upcast), as JAX's
    ``preferred_element_type=float32``."""
    if x.dtype == torch.float32:
        return F.linear(x, wte)
    if x.is_cuda:
        return torch.mm(x, wte.t(), out_dtype=torch.float32)
    return F.linear(x.float(), wte.float())


_Layer = collections.namedtuple("_Layer", "ln_1 qkv proj ln_2 fc fc_proj")


class GPT2Weights:
    """The tensors of one GPT-2 ``state_dict`` the runner reads, per layer
    (the target's, or an explicit draft's)."""

    def __init__(self, sd, n_layer):
        def dense(prefix):
            return (sd[f"{prefix}.weight"], sd.get(f"{prefix}.bias"),
                    sd.get(f"{prefix}.weight_scale"))

        def norm(prefix):
            return sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]

        self.wte, self.wpe = sd["wte"], sd["wpe"]
        self.ln_f = norm("ln_f")
        self.layers = [_Layer(norm(f"h.{i}.ln_1"), dense(f"h.{i}.attn.qkv"),
                             dense(f"h.{i}.attn.proj"), norm(f"h.{i}.ln_2"),
                             dense(f"h.{i}.mlp.fc"), dense(f"h.{i}.mlp.proj"))
                       for i in range(n_layer)]


class PagedGPT2Runner:
    def __init__(self, model, cache, use_flash=None, attention_impl="paged",
                 decode_steps=1, max_batch=None, max_blocks=None,
                 cuda_graph=True):
        """``model``: the port's ``GPT2LMHeadModel`` (its weights, already
        on the device and in the serving dtype); ``cache``: a
        ``PagedKVCache`` with its pools allocated on the same device.
        ``attention_impl``: ``"paged"`` or ``"gather"``. ``use_flash`` is
        accepted only as ``None``: the port has no switch that forces the
        plain version of a kernel. ``max_batch``/``max_blocks`` size the
        CUDA graph's static inputs; ``cuda_graph=False`` runs the gather
        impl eagerly on CUDA too (to hold the graph against)."""
        if use_flash is not None:
            raise ValueError(
                "use_flash must be None: a CUDA tensor launches the "
                "kernel and a CPU tensor runs its plain version")
        if attention_impl not in ("paged", "gather"):
            raise ValueError(f"attention_impl must be 'paged' or 'gather', "
                             f"got {attention_impl!r}")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got "
                             f"{decode_steps}")
        cfg = model.config
        for attr in ("n_layer", "n_head", "n_embd", "n_positions",
                     "vocab_size"):
            if not hasattr(cfg, attr):
                raise ValueError(
                    f"serving needs a GPT2Config-like model config (missing "
                    f"{attr!r}); got {type(cfg).__name__}")
        if getattr(cfg, "moe_num_experts", 0) != 0:
            # the JAX runner refuses MoE too (serving/runner.py:100-101)
            raise NotImplementedError(
                "MoE serving is not supported: the paged runner decodes "
                "dense GPT-2 blocks; generate through init_inference")
        unsupported = {
            "position_embedding != 'learned'":
                getattr(cfg, "position_embedding", "learned") != "learned",
            "pipeline stages": getattr(cfg, "pp_stages", 1) != 1,
            f"attention_mode={getattr(cfg, 'attention_mode', 'auto')!r}":
                getattr(cfg, "attention_mode", "auto") != "auto",
        }
        for what, hit in unsupported.items():
            if hit:
                raise ValueError(f"serving decodes dense GPT-2 with learned "
                                 f"positions; {what} is not supported")
        self.attention_impl = attention_impl
        self.decode_steps = int(decode_steps)
        self.cfg = cfg
        self.cache = cache
        self.n_head = cfg.n_head
        self.head_dim = cfg.n_embd // cfg.n_head
        self.weights = GPT2Weights(model.state_dict(), cfg.n_layer)
        self.device = self.weights.wte.device
        self.max_batch = max_batch
        self.max_blocks = max_blocks
        self._graph = None
        self.graph_launches = collections.Counter()
        if cuda_graph and attention_impl == "gather" \
                and self.device.type == "cuda":
            self._capture()

    # ---------------------------------------------------------- host side
    def upload(self, arr):
        """One host array -> the device: a pinned buffer and an async copy
        on CUDA (the caching host allocator keeps the buffer until the
        copy has run), the array itself on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf.to(self.device, non_blocking=True)

    def step_inputs(self, tok, pos, live, bt, lanes=None):
        """The packed int64 inputs of one decode step: ``[B]`` segments
        (:data:`_SEGMENTS`) then the ``[B, MB]`` table. Inactive slots
        write to the null block; the embedding row is clamped to the
        table (a frozen slot's position may step one past it, as JAX's
        gather clamps); the gather impl's lengths count the current
        token, capped at the window."""
        bs = self.cache.block_size
        MB = bt.shape[1]
        row = bt[np.arange(len(pos)), np.minimum(pos // bs, MB - 1)]
        blk = np.where(live, row, 0)
        if lanes is None:
            lanes = np.zeros((len(pos), 2), np.int64)
        return np.concatenate([
            tok, pos, np.minimum(pos, self.cfg.n_positions - 1), live, blk,
            pos % bs, np.minimum(pos + 1, MB * bs), lanes[:, 0], lanes[:, 1],
            bt.reshape(-1)]).astype(np.int64)

    def unpack(self, ints, B):
        """Views of the packed inputs' segments (and ``bt``)."""
        seg = {name: ints[i * B:(i + 1) * B]
               for i, name in enumerate(_SEGMENTS)}
        seg["bt"] = ints[len(_SEGMENTS) * B:].view(B, -1)
        return seg

    # ------------------------------------------------------------- layers
    def _qkv(self, lp, x):
        N = x.shape[0]
        H, D = self.n_head, self.head_dim
        qkv = _dense(_ln(x, lp.ln_1), lp.qkv)
        q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
        return (q.reshape(N, H, D), k.reshape(N, H, D), v.reshape(N, H, D))

    def _requant(self, kv):
        """What the pool will hold for these rows: int8-round-tripped
        values for the int8 layout, so the current token attends to itself
        as every later step reads it."""
        if not self.cache.int8_kv:
            return kv
        kq, ks = quantize_kv(kv)
        return kq.float() * ks[..., None]

    def _pools(self):
        p = self.cache.pools
        return p["k"], p["v"], p.get("k_scale"), p.get("v_scale")

    def _attn_decode(self, lp, layer, x, s, n_blocks):
        """Paged: attend over the past pool plus the current token from
        registers, return (proj, (k, v)) for the one store after the
        stack. Gather: write this layer's K/V, gather, decode kernel."""
        B, E = x.shape
        q, k, v = self._qkv(lp, x)
        kp, vp, ksp, vsp = self._pools()
        if self.attention_impl == "paged":
            out = paged_decode_attention(
                q, self._requant(k), self._requant(v), layer, kp, vp,
                s["bt"], s["pos"], n_blocks=n_blocks, k_scale_pool=ksp,
                v_scale_pool=vsp)
            return _dense(out.reshape(B, E).to(x.dtype), lp.proj), (k, v)
        self.cache.write_decode(layer, k, v, s["blk"], s["off"])
        kg, vg, ksg, vsg = self.cache.gather(layer, s["bt"])
        out = decode_attention(q[:, :, None, :], kg, vg,
                               s["lens"].to(torch.int32), k_scale=ksg,
                               v_scale=vsg)
        return _dense(out[:, :, 0].reshape(B, E).to(x.dtype), lp.proj), None

    def _mlp(self, lp, x):
        h = F.gelu(_dense(_ln(x, lp.ln_2), lp.fc), approximate="tanh")
        return _dense(h, lp.fc_proj)

    def stack_decode(self, ints, B, n_layers=None, weights=None,
                     n_blocks=0):
        """Embed each slot's token at its own position, run the first
        ``n_layers`` of the stack (default all) of ``weights`` (default
        the target's), write those layers' K/V, return fp32 logits
        ``[B, Vpad]``. ``ints``: the packed inputs of ``B`` slots on the
        device (:meth:`step_inputs`); ``n_blocks``: the paged impl's live
        block count (host int).

        ``n_layers < n_layer`` is the truncated-layer self-draft of
        serving/speculative.py: the target's first layers and its
        ``ln_f`` and tied head, whose K/V equal the target's."""
        W = self.weights if weights is None else weights
        L = len(W.layers) if n_layers is None else int(n_layers)
        s = self.unpack(ints, B)
        x = W.wte[s["tok"]] + W.wpe[s["emb"]].to(W.wte.dtype)
        ks, vs = [], []
        for layer in range(L):
            lp = W.layers[layer]
            a, kv = self._attn_decode(lp, layer, x, s, n_blocks)
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
            x = x + a
            x = x + self._mlp(lp, x)
        if ks:
            self.cache.write_first_layers(torch.stack(ks), torch.stack(vs),
                                          s["blk"], s["off"], L)
        return _head(_ln(x, W.ln_f), W.wte)

    # -------------------------------------------------------- CUDA graph
    def _capture(self):
        """Capture the one-token gather stack over a static, all-inactive
        input buffer (every write lands in the null block), after two
        eager warm-up runs on a side stream. The capture's launches are
        kept in :attr:`graph_launches` and taken out of the counters,
        which the replays feed."""
        if self.max_batch is None or self.max_blocks is None:
            raise ValueError("the CUDA graph needs max_batch and max_blocks")
        B, MB = self.max_batch, self.max_blocks
        self._g_ints = torch.zeros((len(_SEGMENTS) + MB) * B,
                                   dtype=torch.long, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.stack_decode(self._g_ints, B)
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = collections.Counter(op_builder.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._g_logits = self.stack_decode(self._g_ints, B)
        captured = collections.Counter(op_builder.LAUNCHES)
        captured.subtract(before)
        self.graph_launches = +captured      # the kernels a replay runs
        op_builder.LAUNCHES.clear()
        op_builder.LAUNCHES.update(before)
        self._graph = graph

    @property
    def graph_captured(self):
        return self._graph is not None

    def _logits(self, ints, B, n_blocks):
        """One full-stack step: the graph replay when captured (``ints``
        copied into its static buffer), else the eager stack."""
        if self._graph is None:
            return self.stack_decode(ints, B, n_blocks=n_blocks)
        self._g_ints.copy_(ints, non_blocking=True)
        self._graph.replay()
        op_builder.LAUNCHES.update(self.graph_launches)
        return self._g_logits

    # -------------------------------------------------------------- decode
    def n_blocks_for(self, positions):
        """Live blocks of the paged impl: ``ceil(max(positions) / BS)``,
        from host positions."""
        return -(-int(np.max(positions, initial=0)) // self.cache.block_size)

    def decode_step(self, bt, pos, active, tok, temp, top_p, lanes, budget):
        """One decode DISPATCH: ``decode_steps`` tokens per slot,
        budget-capped. Host numpy inputs: bt ``[B, MB]``, pos/active/tok/
        budget ``[B]``, temp/top_p ``[B]`` fp32, lanes ``[B, 2]``. A slot
        past its budget FREEZES: its writes go to the null block, its
        position stops, its tokens are discarded by the host. Returns the
        tokens ``[K, B]`` int64 on the device."""
        B = len(pos)
        all_greedy = bool(np.all(temp <= 0.0))
        if not all_greedy:
            temp_d = self.upload(np.asarray(temp, np.float32))
            top_p_d = self.upload(np.asarray(top_p, np.float32))
        cur = None
        out = []
        for i in range(self.decode_steps):
            step_pos = pos + np.minimum(i, budget)
            live = active & (i < budget)
            ints = self.upload(self.step_inputs(tok, step_pos, live, bt,
                                                lanes))
            s = self.unpack(ints, B)
            if cur is not None:
                s["tok"].copy_(cur)         # the token carried on device
            logits = self._logits(ints, B, self.n_blocks_for(step_pos))
            nxt = sample_tokens(
                logits, None if all_greedy else temp_d,
                None if all_greedy else top_p_d,
                torch.stack([s["lane0"], s["lane1"]], dim=1), s["pos"],
                all_greedy=all_greedy, vocab_size=self.cfg.vocab_size)
            cur = torch.where(s["live"] != 0, nxt, s["tok"])
            out.append(nxt)
        return torch.stack(out)

    # -------------------------------------------------------------- prefill
    def _attn_prefill(self, lp, layer, x, pos, blk, off, bt_row, start):
        """Chunk attention for one slot. Paged: past pages + the chunk
        from registers (the write comes after the stack). Gather: write
        the chunk, then dense masked attention over the slot's view."""
        C, E = x.shape
        D = self.head_dim
        q, k, v = self._qkv(lp, x)                      # [C, H, D]
        qh = q.transpose(0, 1)                          # [H, C, D]
        kp, vp, ksp, vsp = self._pools()
        if self.attention_impl == "paged":
            out = paged_prefill_attention(
                qh, self._requant(k).transpose(0, 1),
                self._requant(v).transpose(0, 1), layer, kp, vp, bt_row,
                start, k_scale_pool=ksp, v_scale_pool=vsp)
            out = out.transpose(0, 1).reshape(C, E).to(x.dtype)
            return _dense(out, lp.proj), (k, v)
        self.cache.write_chunk(layer, k, v, blk, off)
        kg, vg, ksg, vsg = self.cache.gather(layer, bt_row)   # [H, T, D]
        if ksg is not None:
            kg = (kg.float() * ksg[..., None]).to(x.dtype)
            vg = (vg.float() * vsg[..., None]).to(x.dtype)
        scores = (qh.float() @ kg.float().transpose(-1, -2)) * D ** -0.5
        T = kg.shape[1]
        mask = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
        probs = torch.softmax(torch.where(mask[None], scores, NEG_INF), -1)
        out = probs.to(vg.dtype) @ vg
        out = out.transpose(0, 1).reshape(C, E).to(x.dtype)
        return _dense(out, lp.proj), None

    def prefill_chunk(self, bt_row, tokens, start, n_valid):
        """Fill ``n_valid`` prompt tokens of one slot's KV at positions
        ``start ..``; the pad tail writes to the null block. Host inputs:
        bt_row ``[MB]``, tokens ``[C]``, start and n_valid scalars."""
        cfg = self.cfg
        W = self.weights
        bs = self.cache.block_size
        start, n_valid = int(start), int(n_valid)
        C, MB = len(tokens), len(bt_row)
        pos = start + np.arange(C)
        blk = np.where(np.arange(C) < n_valid,
                       bt_row[np.minimum(pos // bs, MB - 1)], 0)
        # the pad tail can step past n_positions: its rows are discarded
        pos_emb = np.minimum(pos, cfg.n_positions - 1)
        ints = self.upload(np.concatenate(
            [tokens, pos, pos_emb, blk, pos % bs, bt_row]).astype(np.int64))
        tok_d, pos_d, emb_d, blk_d, off_d = ints[:5 * C].view(5, C)
        bt_d = ints[5 * C:]
        x = W.wte[tok_d] + W.wpe[emb_d].to(W.wte.dtype)
        ks, vs = [], []
        for layer, lp in enumerate(W.layers):
            a, kv = self._attn_prefill(lp, layer, x, pos_d, blk_d, off_d,
                                       bt_d, start)
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
            x = x + a
            x = x + self._mlp(lp, x)
        if ks:
            self.cache.write_all_layers(torch.stack(ks), torch.stack(vs),
                                        blk_d, off_d)
