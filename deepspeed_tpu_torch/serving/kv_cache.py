"""Paged KV cache — fixed-size blocks, a block allocator and block tables
(counterpart of ``deepspeed_tpu/serving/kv_cache.py``).

The decode KV cache is ONE pool of fixed-size blocks shared by every
request (vLLM/PagedAttention, SOSP '23); each request owns an ordered
block table mapping its logical positions onto pool blocks.

* ``BlockAllocator`` and ``PrefixCache`` are host-side bookkeeping,
  ported as they are: a refcounted free list (block 0 is the reserved
  null block, never handed out) and the content-addressed index of FULL
  blocks under chained ``hashlib.blake2b`` digests, byte-equal to the JAX
  package's.
* ``PagedKVCache`` owns the device pools: layer-stacked tensors
  ``[L, N, H, BS, D]`` on one device (``[L, N, H, BS]`` fp32 row scales
  for the int8 layout). JAX donates the pools to each compiled program
  and re-threads the result; here every write is an in-place indexed
  store, so the pools keep one address for the life of the server (a
  captured CUDA graph reads and writes them where they are).

Inactive slots and the padded tail of a prefill chunk write to the null
block, so several writes may land on one of its rows in one store (in
no defined order). Nothing reads block 0 as live: every read is masked
by a per-slot length.
"""

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from deepspeed_tpu_torch.ops.transformer.decode import quantize_kv


class BlockAllocatorError(RuntimeError):
    pass


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` pool blocks.

    Block 0 is reserved (the null/trash block) and never handed out.
    ``allocate`` is all-or-nothing; ``share`` adds a reference to an
    already-live block (shared-prefix mapping); ``free`` drops one
    reference and recycles the block at zero. Double-frees and foreign
    frees raise with the holding request and the refcount at failure
    named, so an accounting bug fails loudly instead of silently
    corrupting another request's cache.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 usable + the reserved null block), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recently-freed blocks are re-used first (their
        # pool pages are hot)
        self._free = list(range(num_blocks - 1, 0, -1))
        # block id -> live reference count (the historical name is kept:
        # the membership/len reads the tests pin still hold)
        self._allocated = {}
        # block id -> one owner label per reference (len == refcount);
        # labels are request ids / "prefix-cache" / None, purely for the
        # failure messages — policy never reads them
        self._owners = {}
        # block id -> label that dropped the LAST reference (what a
        # double-free names as the probable culprit)
        self._last_freed_by = {}

    @staticmethod
    def _label(owner):
        return "<anonymous>" if owner is None else f"request {owner!r}"

    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    def occupancy(self) -> float:
        """Fraction of usable blocks currently holding live references
        (request tables AND prefix-cache residency)."""
        return len(self._allocated) / max(1, self.num_usable)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, block: int) -> int:
        return self._allocated.get(block, 0)

    def allocate(self, n: int, owner=None):
        """Return ``n`` block ids (each with refcount 1), or ``None``
        when the pool can't cover the request (all-or-nothing; no
        partial grants)."""
        if n < 0:
            raise ValueError(f"allocate({n})")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._allocated[b] = 1
            self._owners[b] = [owner]
        return blocks

    def share(self, blocks, owner=None):
        """Add one reference apiece to already-live blocks (a read-only
        shared-prefix mapping). The null block and free blocks are
        rejected — sharing dead storage is an indexing bug."""
        for b in blocks:
            if b == 0:
                raise BlockAllocatorError(
                    "share of the reserved null block 0 — the null block "
                    "is never refcounted")
            if b not in self._allocated:
                raise BlockAllocatorError(
                    f"share of block {b} which is not allocated "
                    f"(refcount 0) — stale prefix-index entry?")
            self._allocated[b] += 1
            self._owners[b].append(owner)

    def free(self, blocks, owner=None):
        """Drop one reference per block; a block returns to the free
        list when its last reference goes. With ``owner`` given, the
        reference released must actually be held by that owner."""
        for b in blocks:
            rc = self._allocated.get(b, 0)
            if rc == 0:
                culprit = self._last_freed_by.get(b)
                hint = (f"; last released by {self._label(culprit)}"
                        if b in self._last_freed_by else "")
                raise BlockAllocatorError(
                    f"free of block {b} which is not allocated "
                    f"(refcount 0{hint}) — double-free or foreign id")
            owners = self._owners[b]
            if owner is not None and owner not in owners:
                holders = ", ".join(self._label(o) for o in owners)
                raise BlockAllocatorError(
                    f"free of block {b} by {self._label(owner)} which "
                    f"holds no reference to it (refcount {rc}, held by "
                    f"{holders}) — foreign id")
            owners.remove(owner if owner in owners else owners[-1])
            if rc == 1:
                del self._allocated[b]
                del self._owners[b]
                self._last_freed_by[b] = owner
                self._free.append(b)
            else:
                self._allocated[b] = rc - 1

    def check_consistency(self):
        """Invariant check used by the tests: free ∪ allocated is exactly
        the usable id space, the two sets are disjoint, and every live
        block carries one owner label per reference."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockAllocatorError("duplicate ids on the free list")
        live = set(self._allocated)
        if free & live:
            raise BlockAllocatorError(
                f"ids both free and allocated: {free & live}")
        universe = set(range(1, self.num_blocks))
        if free | live != universe:
            raise BlockAllocatorError(
                f"leaked ids: {universe - (free | live)}")
        if 0 in live:
            raise BlockAllocatorError("null block 0 acquired a refcount")
        for b, rc in self._allocated.items():
            if rc < 1 or len(self._owners.get(b, ())) != rc:
                raise BlockAllocatorError(
                    f"block {b}: refcount {rc} != {len(self._owners[b])} "
                    f"owner labels")
        return True


class PrefixCache:
    """Content-addressed shared-prefix index over FULL KV blocks.

    Every full block a request writes is registered under a *chain
    digest* — ``H(parent_digest, token_ids, position_base)`` with the
    cache salt (attention impl, KV dtype, block size) folded into the
    root — so a hit certifies the ENTIRE prefix up to and including the
    block, not just its own tokens (position_base makes the digest
    absolute-position-aware; learned position embeddings mean the same
    tokens at a different offset are different KV). Admission walks a
    prompt block-by-block against the index and maps every hit
    read-only; the index holds ONE allocator reference per resident
    block, so finished requests' prefixes stay warm until LRU eviction
    (capacity bound) or :meth:`reclaim` — the scheduler's
    cheaper-than-preemption block source.

    int8-KV pools share bit-exactly: quantize-on-write makes a block's
    stored bytes a deterministic function of (tokens, positions,
    params), so a reader cannot tell a shared block from one it wrote
    itself.
    """

    OWNER = "prefix-cache"

    def __init__(self, allocator, block_size, capacity_blocks=0, salt=""):
        self.allocator = allocator
        self.block_size = int(block_size)
        # 0 = bounded only by the pool itself
        self.capacity_blocks = int(capacity_blocks)
        self._root = hashlib.blake2b(
            f"prefix/{salt}/{block_size}".encode(),
            digest_size=16).digest()
        # digest -> block id, insertion/touch-ordered (last = hottest)
        self._index = OrderedDict()
        self._digest_of = {}            # block id -> digest (evict path)
        self.hits = 0                   # full prompt blocks mapped from
        self.misses = 0                 # ... / not found at admission
        self.insertions = 0
        self.evictions = 0
        self.cow_forks = 0

    # ----------------------------------------------------------- hashing
    @property
    def root_digest(self):
        return self._root

    def chain_digest(self, parent, tokens, position_base):
        h = hashlib.blake2b(digest_size=16)
        h.update(self._root if parent is None else parent)
        h.update(np.asarray(tokens, np.int64).tobytes())
        h.update(int(position_base).to_bytes(8, "little", signed=False))
        return h.digest()

    # ------------------------------------------------------------ lookup
    def _walk(self, tokens, touch):
        """Longest chain of FULL blocks of ``tokens`` present in the
        index: ``(block_ids, digests)``. ``touch`` refreshes LRU."""
        bs = self.block_size
        blocks, digests = [], []
        parent = self._root
        for j in range(len(tokens) // bs):
            d = self.chain_digest(parent, tokens[j * bs:(j + 1) * bs],
                                  j * bs)
            b = self._index.get(d)
            if b is None:
                break
            if touch:
                self._index.move_to_end(d)
            blocks.append(b)
            digests.append(d)
            parent = d
        return blocks, digests

    def lookup(self, tokens):
        """Admission walk (LRU-touching). Returns the matched leading
        ``(block_ids, digests)`` — counters are booked separately via
        :meth:`record_lookup` once the admission actually lands, so a
        blocked FCFS head retrying every iteration doesn't inflate the
        hit rate."""
        return self._walk(tokens, touch=True)

    def match_blocks(self, tokens) -> int:
        """Pure peek (no LRU touch, no counters): how many leading full
        blocks of ``tokens`` this cache holds. The router's
        prefix-affinity signal."""
        return len(self._walk(tokens, touch=False)[0])

    def record_lookup(self, hit_blocks, full_blocks):
        self.hits += hit_blocks
        self.misses += max(0, full_blocks - hit_blocks)

    # ------------------------------------------------------------ insert
    def insert(self, parent, tokens, position_base, block) -> bytes:
        """Register one FULL block under its chain digest and take the
        index's reference. Returns the digest (the caller threads it as
        the next block's parent). A digest already resident keeps its
        existing block (first writer wins — later identical blocks are
        NOT swapped in, so live sharers never see a remap); over
        capacity the LRU tail is reclaimed first, and when nothing is
        reclaimable the insert is skipped (never steals live blocks)."""
        d = self.chain_digest(parent, tokens, position_base)
        if d in self._index:
            self._index.move_to_end(d)
            return d
        if block == 0:
            raise BlockAllocatorError(
                "prefix-index insert of the reserved null block 0")
        if self.capacity_blocks and len(self._index) >= self.capacity_blocks:
            if self.reclaim(
                    len(self._index) - self.capacity_blocks + 1) == 0:
                return d        # bound holds; chain digest still valid
        self.allocator.share([block], owner=self.OWNER)
        self._index[d] = block
        self._digest_of[block] = d
        self.insertions += 1
        return d

    # ---------------------------------------------------------- eviction
    def resident_blocks(self) -> int:
        return len(self._index)

    def reclaimable_blocks(self) -> int:
        """Resident blocks whose ONLY reference is the index's own."""
        rc = self.allocator.refcount
        return sum(1 for b in self._index.values() if rc(b) == 1)

    def shared_blocks(self) -> int:
        """Resident blocks currently mapped by at least one request —
        the ``serving_prefix_blocks_shared`` gauge."""
        rc = self.allocator.refcount
        return sum(1 for b in self._index.values() if rc(b) > 1)

    def reclaim(self, n: int) -> int:
        """Drop up to ``n`` cold cache-only entries (LRU first),
        returning their blocks to the free list. Entries still mapped by
        a request are skipped — reclaim never breaks a live table. The
        scheduler calls this BEFORE preempting anyone: a cold cached
        block is free capacity, a preemption is recompute debt."""
        if n <= 0:
            return 0
        freed = 0
        for d in list(self._index):
            if freed >= n:
                break
            b = self._index[d]
            if self.allocator.refcount(b) != 1:
                continue        # a request still maps it
            del self._index[d]
            del self._digest_of[b]
            self.allocator.free([b], owner=self.OWNER)
            self.evictions += 1
            freed += 1
        return freed

    def drop_all(self) -> int:
        """Release every cache-only entry (teardown / leak checks)."""
        return self.reclaim(len(self._index))

    def stats(self):
        total = self.hits + self.misses
        return {
            "resident_blocks": len(self._index),
            "reclaimable_blocks": self.reclaimable_blocks(),
            "shared_blocks": self.shared_blocks(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 6) if total else 0.0,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "cow_forks": self.cow_forks,
            "capacity_blocks": self.capacity_blocks,
        }


class PagedKVCache:
    """Device block pools and the indexed writes and gathers the runner
    makes. ``init_pools(device)`` allocates them (zeroed):

    * ``k``/``v``: ``[n_layer, num_blocks, H, block_size, D]`` in the
      activation dtype, or int8 when ``int8_kv``;
    * ``k_scale``/``v_scale`` (int8 only): ``[n_layer, num_blocks, H,
      block_size]`` fp32 per-row absmax scales.
    """

    def __init__(self, n_layer, n_head, head_dim, block_size, num_blocks,
                 dtype=torch.float32, int8_kv=False):
        self.n_layer = n_layer
        self.n_head = n_head
        self.head_dim = head_dim
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.int8_kv = bool(int8_kv)
        self.dtype = torch.int8 if int8_kv else dtype
        self.allocator = BlockAllocator(num_blocks)
        # shared-prefix index (None = prefix caching off); the server
        # attaches it from the serving.prefix_cache block
        self.prefix_cache = None
        self.pools = None

    def attach_prefix_cache(self, capacity_blocks=0, attention_impl=""):
        """Arm shared-prefix reuse. The salt folds in what makes two equal
        token prefixes produce different block bytes (attention impl, KV
        dtype, block size), with the JAX package's dtype names."""
        self.prefix_cache = PrefixCache(
            self.allocator, self.block_size,
            capacity_blocks=capacity_blocks,
            salt=f"{attention_impl}|{str(self.dtype).replace('torch.', '')}")
        return self.prefix_cache

    # -------------------------------------------------- pool construction
    def init_pools(self, device):
        """Allocate the zeroed pools on ``device``; returns them."""
        L, N, H, BS, D = (self.n_layer, self.num_blocks, self.n_head,
                          self.block_size, self.head_dim)
        self.pools = {
            "k": torch.zeros((L, N, H, BS, D), dtype=self.dtype,
                             device=device),
            "v": torch.zeros((L, N, H, BS, D), dtype=self.dtype,
                             device=device),
        }
        if self.int8_kv:
            for name in ("k_scale", "v_scale"):
                self.pools[name] = torch.zeros((L, N, H, BS),
                                               dtype=torch.float32,
                                               device=device)
        return self.pools

    def pool_bytes(self) -> int:
        """Device bytes the pools occupy (for the serving metrics)."""
        N, H, BS, D = (self.num_blocks, self.n_head, self.block_size,
                       self.head_dim)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_layer = 2 * N * H * BS * D * itemsize
        if self.int8_kv:
            per_layer += 2 * N * H * BS * 4
        return per_layer * self.n_layer

    # ------------------------------------------------------ device writes
    def _store(self, layers, k, v, block_ids, offsets):
        """``pool[layers, block_ids[i], :, offsets[i], :] = row i`` for K
        and V (quantized on write for the int8 layout). k/v: ``[B, H, D]``
        when ``layers`` is one layer, ``[B, n, H, D]`` for a layer
        slice."""
        p = self.pools
        if self.int8_kv:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            p["k_scale"][layers][..., block_ids, :, offsets] = ks
            p["v_scale"][layers][..., block_ids, :, offsets] = vs
        dt = p["k"].dtype
        p["k"][layers][..., block_ids, :, offsets, :] = k.to(dt)
        p["v"][layers][..., block_ids, :, offsets, :] = v.to(dt)

    def write_decode(self, layer, k_new, v_new, block_ids, offsets):
        """Write one token's (or one chunk's) K/V into ONE layer's pages,
        in place. k_new/v_new: ``[B, H, D]``; block_ids/offsets: ``[B]``
        int64 on the pools' device (inactive rows name block 0). The
        ``gather`` impl's write: its kernel reads the current token from
        the pool."""
        self._store(layer, k_new, v_new, block_ids, offsets)

    write_chunk = write_decode      # [C, H, D]: C plays B's role

    def write_first_layers(self, k_all, v_all, block_ids, offsets,
                           n_layers):
        """Write the first ``n_layers`` layers' K/V in one store apiece:
        k_all/v_all ``[n_layers, B, H, D]``. All layers for the ``paged``
        impl (``n_layers == n_layer``); the truncated-layer self-draft's
        layer prefix (serving/speculative.py), whose K/V equal the
        target's, so its speculative positions land in the same pools."""
        self._store(slice(0, int(n_layers)), k_all.transpose(0, 1),
                    v_all.transpose(0, 1), block_ids, offsets)

    def write_all_layers(self, k_all, v_all, block_ids, offsets):
        """Every layer's K/V for this step: ``[L, B, H, D]``."""
        self.write_first_layers(k_all, v_all, block_ids, offsets,
                                self.n_layer)

    def copy_block(self, src, dst):
        """``pool[:, dst] = pool[:, src]`` for every pool and layer: the
        prefix cache's copy-on-write fork, one device copy a pool."""
        src, dst = int(src), int(dst)
        for p in self.pools.values():
            p[:, dst] = p[:, src]

    # ------------------------------------------------------ device gather
    def gather(self, layer, block_tables):
        """Block table -> contiguous per-slot views.

        block_tables: ``[B, MB]`` (or ``[MB]`` for one slot) int64 on the
        pools' device. Returns ``(k, v, k_scale, v_scale)``: k/v
        contiguous ``[B, H, MB*block_size, D]`` (scales ``[B, H, T]`` or
        ``None``), what ``decode_attention`` reads with per-slot lengths
        masking the tail."""
        squeeze = block_tables.dim() == 1
        bt = block_tables[None] if squeeze else block_tables
        B, MB = bt.shape
        T = MB * self.block_size
        H = self.n_head

        def g(pool, *tail):   # [N, H, BS, ...] -> [B, H, T, ...]
            x = pool[layer][bt]                       # [B, MB, H, BS, ...]
            return x.transpose(1, 2).reshape(B, H, T, *tail)

        k = g(self.pools["k"], self.head_dim)
        v = g(self.pools["v"], self.head_dim)
        ks = vs = None
        if self.int8_kv:
            ks = g(self.pools["k_scale"])
            vs = g(self.pools["v_scale"])
        if squeeze:
            k, v = k[0], v[0]
            if ks is not None:
                ks, vs = ks[0], vs[0]
        return k, v, ks, vs

    # ------------------------------------------------------- host helpers
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return max(1, -(-int(n_tokens) // self.block_size))

    def table_array(self, block_tables, max_blocks, n_rows=None):
        """Host block tables (lists of ids) -> padded ``[B, MB]`` int64
        numpy array, null-block padded; ``None`` rows (empty slots) are
        all null."""
        if n_rows is None:
            n_rows = len(block_tables)
        out = np.zeros((n_rows, max_blocks), np.int64)
        for i, tbl in enumerate(block_tables):
            if tbl:
                out[i, :len(tbl)] = tbl
        return out
