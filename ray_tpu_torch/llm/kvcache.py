"""Paged KV cache: fixed-size token blocks, prefix reuse, COW, LRU.

Counterpart of ``ray_tpu/llm/kvcache.py``. The host bookkeeping
(``chain_hashes``, ``KVBlockManager`` with its ``metrics=`` hooks,
``TRASH``, ``BlockPoolExhausted``) and ``kvcache_metrics`` are copies of
the JAX package's, on the port's own metrics registry, so the port never
imports ``ray_tpu``. The device half works on torch tensors:

- the POOL is one preallocated tensor pair per engine,
  ``(layers, num_blocks, block_size, kv_heads, head_dim)``;
- each request owns a BLOCK TABLE of physical block ids; decode writes
  the new token's KV through it and attends either straight through it
  (``paged_flash``: the hand-written kernel) or through a gathered view
  (``gather``: the plain path);
- where the JAX package donates the pool to a jitted update, the port
  updates the pool tensors in place (``index_put_``/``index_copy_``);
- under a tensor-parallel mesh each of k/v is a list of per-shard
  tensors split on the kv-head dim; every block op applies the same
  block ids to every shard, and decode attends per shard.

Physical block 0 is the TRASH block: writes for finished/empty slots and
bucket-padding garbage land there; it is never read unmasked. Several
empty slots write trash position 0 in the same step, so that scatter
has duplicate indices and an unspecified winner, which is harmless.
"""

from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.llm.model import kv_zeros, map_parts, parts as _parts

TRASH = 0   # physical block 0: garbage-write target, never allocated


def kvcache_metrics() -> dict:
    """Get-or-create the paged-KV gauges/counters (shared process
    registry, pushed to the head like every llm_* series). Catalog:

      llm_kv_blocks_used          blocks referenced by live requests
      llm_kv_blocks_cached        refcount-0 blocks held by the prefix
                                  index (reclaimable via LRU eviction)
      llm_kv_blocks_evicted_total cached chains evicted under pressure
      llm_prefix_hit_tokens_total prompt tokens whose prefill was
                                  skipped via a prefix-cache hit
      llm_kv_handoff_bytes_total  KV bytes shipped prefill->decode at
                                  block granularity (llm/pd.py)
      llm_paged_attn_steps_total  paged decode steps by attention impl
                                  ({impl}: paged_flash | gather)
      llm_kv_gather_bytes_avoided_total
                                  HBM bytes the fused kernel did NOT
                                  copy materializing the gathered view
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "used": m.Gauge(
            "llm_kv_blocks_used",
            "KV pool blocks referenced by live requests"),
        "cached": m.Gauge(
            "llm_kv_blocks_cached",
            "Refcount-0 KV pool blocks held by the prefix index "
            "(reclaimable by LRU eviction)"),
        "evicted": m.Counter(
            "llm_kv_blocks_evicted_total",
            "Cached KV blocks evicted from the prefix index under "
            "pool pressure"),
        "hit_tokens": m.Counter(
            "llm_prefix_hit_tokens_total",
            "Prompt tokens served from cached prefix blocks instead "
            "of prefill compute"),
        "handoff_bytes": m.Counter(
            "llm_kv_handoff_bytes_total",
            "KV bytes shipped prefill->decode at block granularity "
            "in the disaggregated path"),
        "attn_steps": m.Counter(
            "llm_paged_attn_steps_total",
            "Paged decode steps taken, tagged by attention impl "
            "(paged_flash = fused block-table kernel, gather = "
            "materialized view)",
            tag_keys=("impl",)),
        "gather_avoided": m.Counter(
            "llm_kv_gather_bytes_avoided_total",
            "HBM bytes the fused paged-attention kernel avoided "
            "copying versus materializing the gathered "
            "(slots, max_len) attention view every decode step"),
    }


def chain_hashes(tokens: Sequence[int], block_size: int, *,
                 seed: bytes = b"", start_block: int = 0) -> List[str]:
    """One digest per FULL block of ``tokens`` from ``start_block``
    on; each digest covers the entire prefix up to that block's end
    (hash chaining), so equal digests imply equal prefixes — the
    prefix-index key. ``seed`` is the digest of block start_block-1
    (chain extension: free_seq continues a stored prompt chain over
    the generated tokens without rehashing the prompt)."""
    out: List[str] = []
    h = seed
    for i in range(start_block, len(tokens) // block_size):
        blk = tokens[i * block_size:(i + 1) * block_size]
        d = hashlib.blake2b(digest_size=16)
        d.update(h)
        d.update(np.asarray(blk, np.int64).tobytes())
        h = d.digest()
        out.append(h.hex())
    return out


@dataclass
class _CacheEntry:
    phys: int
    hash: str
    parent: Optional[str]       # previous block's chain hash
    children: int = 0           # cached continuations (evict leaves 1st)
    last_used: int = 0          # manager tick, LRU order


@dataclass
class _Seq:
    table: List[int]            # logical block idx -> physical id
    n_prompt: int
    hit_tokens: int
    hashes: List[str] = field(default_factory=list)  # full prompt blocks


class BlockPoolExhausted(RuntimeError):
    """The request can NEVER fit: its full horizon needs more blocks
    than the pool holds even if everything cacheable were evicted."""


class KVBlockManager:
    """Host-side accounting for one engine's block pool. Not
    thread-safe by itself — the engine serializes admits/frees on its
    scheduler loop, matching the monolithic cache's discipline."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 table_width: int, prefix_cache: bool = True,
                 metrics: Optional[dict] = None):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is trash)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.table_width = int(table_width)
        self.prefix_cache = bool(prefix_cache)
        self.free: deque = deque(range(1, num_blocks))   # 0 = trash
        self.ref: Dict[int, int] = {}                    # phys -> count
        self.entries: Dict[str, _CacheEntry] = {}        # hash -> entry
        self.by_phys: Dict[int, _CacheEntry] = {}
        self.seqs: Dict[object, _Seq] = {}
        self.evicted_total = 0
        self.hit_tokens_total = 0
        self._tick = 0
        self._m = metrics

    # -- introspection ---------------------------------------------------

    def used_blocks(self) -> int:
        return sum(1 for c in self.ref.values() if c > 0)

    def cached_blocks(self) -> int:
        return sum(1 for h, e in self.entries.items()
                   if self.ref.get(e.phys, 0) == 0)

    def free_blocks(self) -> int:
        return len(self.free)

    def _publish(self) -> None:
        if self._m is None:
            return
        self._m["used"].set(self.used_blocks())
        self._m["cached"].set(self.cached_blocks())

    def blocks_needed(self, n_tokens: int, max_new: int) -> int:
        """Full-horizon reservation: admission allocates every block
        the request can ever touch, so decode can never fail mid-
        flight on pool pressure (the pool's overload answer is a
        queued admit, not a dropped stream)."""
        return -(-(n_tokens + max_new) // self.block_size)

    # -- prefix lookup ---------------------------------------------------

    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """(hit_tokens, physical blocks) for the longest cached chain
        of FULL prompt blocks — capped one token short of the prompt
        so the last token's logits always come from live compute (a
        full-hit request still needs something to sample from)."""
        hit, phys, _ = self._lookup(tokens)
        return hit, phys

    def _lookup(self, tokens: Sequence[int]
                ) -> Tuple[int, List[int], List[str]]:
        """lookup + the prompt's chain hashes (alloc_seq records them
        on the sequence — hashing a long prompt once, not twice)."""
        hashes = chain_hashes(tokens, self.block_size) \
            if self.prefix_cache else []
        if not self.prefix_cache:
            return 0, [], hashes
        cap_blocks = (len(tokens) - 1) // self.block_size
        phys: List[int] = []
        self._tick += 1
        for h in hashes[:cap_blocks]:
            e = self.entries.get(h)
            if e is None:
                break
            e.last_used = self._tick
            phys.append(e.phys)
        return len(phys) * self.block_size, phys, hashes

    # -- allocation ------------------------------------------------------

    def alloc_seq(self, seq_id, tokens: Sequence[int],
                  max_new: int) -> Optional[dict]:
        """Admit one request: adopt the cached prefix (ref-counted),
        reserve fresh blocks for the rest of its horizon. Returns
        {"table": np.int32 (table_width,), "hit_tokens": int,
        "new_blocks": [phys]} — or None when the pool can't cover it
        right now (caller re-queues the request; eviction of
        refcount-0 chains was already attempted). Raises
        BlockPoolExhausted when the request can never fit."""
        if seq_id in self.seqs:
            raise ValueError(f"seq {seq_id!r} already allocated")
        n = len(tokens)
        total = self.blocks_needed(n, max_new)
        if total > self.table_width:
            raise BlockPoolExhausted(
                f"request horizon spans {total} blocks > table width "
                f"{self.table_width}")
        if total > self.num_blocks - 1:
            raise BlockPoolExhausted(
                f"request horizon needs {total} blocks; pool holds "
                f"{self.num_blocks - 1}")
        hit_tokens, hit_phys, hashes = self._lookup(tokens)
        # pin the hit blocks BEFORE any eviction: at refcount 0 they
        # are themselves eviction candidates once their chain suffix
        # is gone, and an evicted-then-reallocated hit block would
        # appear TWICE in the table (prefix view + fresh write target)
        # — silent KV corruption
        for p in hit_phys:
            self.ref[p] = self.ref.get(p, 0) + 1
        need = total - len(hit_phys)
        if need > len(self.free):
            self.evict(need - len(self.free))
        if need > len(self.free):
            for p in hit_phys:          # un-pin; caller re-queues
                self._release(p)
            return None
        table = np.full((self.table_width,), TRASH, np.int32)
        for i, p in enumerate(hit_phys):
            table[i] = p
        new_blocks = []
        for i in range(len(hit_phys), total):
            p = self.free.popleft()
            self.ref[p] = 1
            table[i] = p
            new_blocks.append(p)
        self.seqs[seq_id] = _Seq(list(table), n, hit_tokens, hashes)
        self.hit_tokens_total += hit_tokens
        if self._m is not None and hit_tokens:
            self._m["hit_tokens"].inc(hit_tokens)
        self._publish()
        return {"table": table, "hit_tokens": hit_tokens,
                "new_blocks": new_blocks}

    def _release(self, phys: int) -> None:
        """Drop one live reference; a block neither referenced nor
        cached returns to the free list."""
        c = self.ref.get(phys, 0) - 1
        if c > 0:
            self.ref[phys] = c
            return
        self.ref.pop(phys, None)
        if phys not in self.by_phys and phys != TRASH:
            self.free.append(phys)

    def free_seq(self, seq_id, out_tokens: Sequence[int] = (),
                 cache: bool = True) -> None:
        """Finish one request: insert its full-block chain (prompt +
        generated tokens — a follow-up turn extends the same chain)
        into the prefix index, then drop the live references. Cached
        blocks stay resident at refcount 0 until LRU eviction.
        ``cache=False`` skips the insert — REQUIRED for a request
        whose KV was never written (admit failed before the scatter):
        indexing its zero/stale blocks under the prompt's chain hashes
        would poison every later request sharing the prefix."""
        seq = self.seqs.pop(seq_id, None)
        if seq is None:
            return
        if self.prefix_cache and cache:
            # ``out_tokens`` is the FULL token stream (prompt +
            # generated) when the caller wants generated full blocks
            # cached too (a follow-up conversation turn extends the
            # same chain); absent, the alloc-time prompt hashes
            # serve. The stored prompt chain is EXTENDED from its
            # last digest — the prompt (a 100k shared context on the
            # target workload) is never rehashed at finish.
            hashes = seq.hashes
            if len(out_tokens) >= seq.n_prompt:
                seed = bytes.fromhex(hashes[-1]) if hashes else b""
                hashes = hashes + chain_hashes(
                    list(out_tokens), self.block_size, seed=seed,
                    start_block=len(hashes))
            self._tick += 1
            parent: Optional[str] = None
            for i, h in enumerate(hashes):
                phys = seq.table[i]
                if phys == TRASH:
                    break
                cur = self.entries.get(h)
                if cur is None:
                    # only cache blocks this seq exclusively owns or
                    # already-cached shared ones; a shared-but-uncached
                    # block (fork) must not be indexed under a hash
                    # another writer could invalidate
                    e = _CacheEntry(phys, h, parent,
                                    last_used=self._tick)
                    if phys in self.by_phys:
                        # same phys already cached under another hash
                        # (can't happen via chain hashing; guard)
                        break
                    self.entries[h] = e
                    self.by_phys[phys] = e
                    if parent is not None and parent in self.entries:
                        self.entries[parent].children += 1
                else:
                    cur.last_used = self._tick
                parent = h
        for phys in seq.table:
            if phys != TRASH:
                self._release(phys)
        self._publish()

    # -- copy-on-write / fork --------------------------------------------

    def fork_seq(self, src_id, dst_id) -> List[int]:
        """Share every block of ``src`` with a new sequence (parallel
        sampling / beam fork). Writes to shared blocks must go through
        ensure_writable."""
        src = self.seqs.get(src_id)
        if src is None:
            raise KeyError(src_id)
        if dst_id in self.seqs:
            raise ValueError(f"seq {dst_id!r} already allocated")
        for p in src.table:
            if p != TRASH:
                self.ref[p] = self.ref.get(p, 0) + 1
        self.seqs[dst_id] = _Seq(list(src.table), src.n_prompt,
                                 src.hit_tokens, list(src.hashes))
        self._publish()
        return list(src.table)

    def ensure_writable(self, seq_id,
                        logical: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard: before writing into ``logical``, a
        block that is shared (refcount > 1) or held by the prefix
        index is replaced by a private copy. Returns (old_phys,
        new_phys) when the caller must issue the device block copy,
        None when the block was already private."""
        seq = self.seqs[seq_id]
        phys = seq.table[logical]
        if phys == TRASH:
            return None
        if self.ref.get(phys, 0) <= 1 and phys not in self.by_phys:
            return None
        if not self.free:
            self.evict(1)
        if not self.free:
            return None     # caller treats as pool pressure
        new = self.free.popleft()
        self.ref[new] = 1
        seq.table[logical] = new
        self._release(phys)
        self._publish()
        return phys, new

    def truncate_seq(self, seq_id, n_tokens: int, *,
                     min_blocks: int = 0) -> List[int]:
        """Roll a live sequence back to its first ``n_tokens`` tokens —
        the speculative-decode rejection path, and the branch-abandon
        primitive for COW forks. Table blocks whose every position lies
        beyond ``n_tokens`` are released (refcount decrement: a shared
        or prefix-indexed block survives for its other holders — the
        prefix index's own accounting is never touched) and the row is
        re-pointed at trash. The sequence's hash chain is cut to the
        full blocks ``n_tokens`` still covers, so a digest over
        truncated content can never reach the prefix index at
        ``free_seq`` — a rolled-back draft tail must never satisfy a
        later prefix hit.

        ``min_blocks`` keeps at least that many leading table rows
        (the engine passes its full-horizon reservation so a rollback
        never returns blocks admission already promised the request —
        re-acquiring them later could deadlock against a newer admit).
        No device op: rejected-draft KV lives beyond the sequence's
        logical length, so it is masked out of every attention (exact
        zeros) and overwritten by the next real write at that position.
        Returns the physical blocks released."""
        seq = self.seqs.get(seq_id)
        if seq is None:
            raise KeyError(seq_id)
        keep = max(-(-n_tokens // self.block_size), min_blocks)
        freed: List[int] = []
        for i in range(len(seq.table) - 1, keep - 1, -1):
            phys = seq.table[i]
            if phys == TRASH:
                continue
            seq.table[i] = TRASH
            self._release(phys)
            freed.append(phys)
        seq.hashes = seq.hashes[:n_tokens // self.block_size]
        seq.n_prompt = min(seq.n_prompt, n_tokens)
        self._publish()
        return freed

    # -- eviction --------------------------------------------------------

    def evict(self, k: int) -> int:
        """Evict up to ``k`` cached refcount-0 blocks, LRU leaf-first
        (children evict before parents so surviving chains stay
        walkable from the root). One heapify + O(k log n) — this runs
        on the engine's serialized admit path, so a per-block rescan
        of every cache entry would stall in-flight streams under a
        large prefix cache. Returns blocks actually freed."""
        import heapq
        heap = [(e.last_used, e.hash) for e in self.entries.values()
                if e.children == 0 and self.ref.get(e.phys, 0) == 0]
        heapq.heapify(heap)
        freed = 0
        while freed < k and heap:
            _, h = heapq.heappop(heap)
            e = self.entries.get(h)
            if e is None or e.children != 0 \
                    or self.ref.get(e.phys, 0) != 0:
                continue            # stale heap entry
            del self.entries[h]
            self.by_phys.pop(e.phys, None)
            if e.parent is not None:
                p = self.entries.get(e.parent)
                if p is not None:
                    p.children -= 1
                    if p.children == 0 and \
                            self.ref.get(p.phys, 0) == 0:
                        heapq.heappush(heap, (p.last_used, p.hash))
            self.free.append(e.phys)
            freed += 1
            self.evicted_total += 1
            if self._m is not None:
                self._m["evicted"].inc()
        if freed:
            self._publish()
        return freed


# --- device ops -----------------------------------------------------------


def init_pool(cfg, num_blocks: int, block_size: int, dtype: torch.dtype,
              device, mesh=None) -> dict:
    """The pool tensors: k/v of shape
    (layers, num_blocks, block_size, kv_heads, head_dim), zeroed. With
    ``mesh``, each of k/v is a list of one (layers, num_blocks,
    block_size, kv_heads/tp, head_dim) tensor per mesh device (the JAX
    pool's kv-head sharding); block ids index dim 1 of every shard."""
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {key: kv_zeros(shape, dtype, device, mesh) for key in ("k", "v")}


def pool_block_bytes(pool: dict) -> int:
    """Device bytes one block costs (k + v, all layers, all shards)."""
    ks, vs = _parts(pool["k"]), _parts(pool["v"])
    return sum((k.nbytes + v.nbytes) // k.shape[1] for k, v in zip(ks, vs))


def auto_pool_blocks(slots: int, table_width: int, block_bytes: int,
                     configured: int = 0, device=None) -> int:
    """Pool size: the explicit knob wins; otherwise the worst case (every
    slot at max_len) plus one full chain of prefix-cache headroom, capped
    on a CUDA device at half its free memory (the engine is not the only
    tenant). The cap never shrinks below one full-horizon request
    (table_width blocks). ``device`` may be a list, one device per
    tensor shard (repeats allowed), with ``block_bytes`` the bytes of
    one block over all shards: each CUDA device is then charged for the
    shards it holds, once, before any shard is allocated."""
    if configured:
        return max(2, int(configured))
    base = slots * table_width + table_width
    devices = [] if device is None else [
        torch.device(d) for d in (device if isinstance(device, (list, tuple))
                                  else [device])]
    for dev in dict.fromkeys(devices):
        if dev.type != "cuda":
            continue
        on_dev = block_bytes * devices.count(dev) // len(devices)
        free, _ = torch.cuda.mem_get_info(dev)
        cap = int(free * 0.5 // max(1, on_dev))
        base = max(table_width, min(base, cap))
    return base + 1     # + trash block


def _phys(phys, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(phys), dtype=torch.long,
                           device=device)


def scatter_bucket(pool: dict, kv: dict, phys, nb: int) -> dict:
    """Write a bucket-padded prefill's KV (layers, nb*bs, kvh, hd) into
    ``nb`` physical blocks, in place (pad-garbage blocks are redirected
    to trash by the caller's ``phys``). A sharded pool takes per-shard KV
    and writes the same blocks of every shard."""
    for key in ("k", "v"):
        for p, src in zip(_parts(pool[key]), _parts(kv[key])):
            bs = p.shape[2]
            src = src.reshape(src.shape[0], nb, bs, *src.shape[2:])
            p.index_copy_(1, _phys(phys, p.device), src.to(p.dtype))
    return pool


def gather_table(pool: dict, phys, acc_len: int) -> dict:
    """Gather one block table's KV into a contiguous accumulator
    (layers, acc_len, kvh, hd) for chunked prefill over a cached prefix
    (per shard for a sharded pool). acc_len >= table_width * block_size
    (zero tail)."""
    def gather(p):
        L, _, bs, kvh, hd = p.shape
        idx = _phys(phys, p.device)
        w = idx.shape[0]
        acc = torch.zeros((L, acc_len, kvh, hd), dtype=p.dtype,
                          device=p.device)
        acc[:, :w * bs] = p[:, idx].reshape(L, w * bs, kvh, hd)
        return acc
    return {key: map_parts(gather, pool[key]) for key in ("k", "v")}


def scatter_table(pool: dict, acc: dict, phys) -> dict:
    """Write an accumulator back through a full-width physical target
    vector, in place (shared-prefix and beyond-horizon entries point at
    trash, so shared blocks are never written); per shard for a sharded
    pool, with the same targets."""
    for key in ("k", "v"):
        for p, a in zip(_parts(pool[key]), _parts(acc[key])):
            L, _, bs, kvh, hd = p.shape
            idx = _phys(phys, p.device)
            w = idx.shape[0]
            p[:, idx] = a[:, :w * bs].reshape(L, w, bs, kvh, hd).to(p.dtype)
    return pool


def copy_block(pool: dict, src: int, dst: int) -> dict:
    """Device-side block copy (the COW divergence path), in place, in
    every shard."""
    for key in ("k", "v"):
        for p in _parts(pool[key]):
            p[:, dst] = p[:, src]
    return pool


def resolve_attn_impl(impl: str, device) -> str:
    """Resolve the paged decode attention impl. ``auto`` is the
    block-table kernel on a CUDA device and the gathered view (the plain
    path) on the CPU; ``paged_flash`` and ``gather`` are explicit
    choices (``paged_flash`` on the CPU runs the kernel's plain
    version)."""
    if impl not in ("auto", "paged_flash", "gather"):
        raise ValueError(
            f"paged attn impl must be auto|paged_flash|gather, "
            f"got {impl!r}")
    if impl == "auto":
        cuda = torch.device(device).type == "cuda"
        return "paged_flash" if cuda else "gather"
    return impl


def _paged_decode_core(model, pool, tables, lengths, tokens, temps,
                       generator, cfg, top_ps=None, top_ks=None, *,
                       impl="auto"):
    """One token for every slot against the paged pool: the shared
    decode transformer with block-table write/attend plugged in. The new
    token's KV is written into the pool in place. For a ``ShardedLlama``
    (its pool split over the same mesh) the hooks run once per shard on
    its kv heads, with the block tables and lengths replicated, as the
    JAX package's ``shard_map`` over its kernel does: K4 launches once
    per shard."""
    from ray_tpu_torch.llm.model import decode_token_core
    impl = resolve_attn_impl(impl, _parts(pool["k"])[0].device)
    b = tokens.shape[0]
    bs = _parts(pool["k"])[0].shape[2]
    w = tables.shape[1]
    hd = cfg.head_dim
    positions = lengths
    blk = torch.clamp(positions // bs, 0, w - 1).long()
    off = (positions % bs).long()
    phys = tables[torch.arange(b, device=tables.device), blk].long()

    def write(ck, cv, k, v):    # ck/cv: (num_blocks, bs, kvh, hd)
        at = (phys.to(ck.device), off.to(ck.device))
        ck.index_put_(at, k.to(ck.dtype))
        cv.index_put_(at, v.to(cv.dtype))

    def view(ck, cv):
        t = tables.to(ck.device).long()
        kvh = ck.shape[2]
        return (ck[t].reshape(b, w * bs, kvh, hd),
                cv[t].reshape(b, w * bs, kvh, hd))

    attend = None
    if impl == "paged_flash":
        from ray_tpu_torch.ops.paged_attention import paged_attention

        def attend(q, ck, cv, pos):     # q: (b, h, hd), one shard's heads
            qg = q.reshape(b, ck.shape[2], -1, hd)
            o = paged_attention(qg, ck, cv, tables.to(ck.device), pos + 1)
            return o.reshape(b, -1)

    return decode_token_core(model, pool["k"], pool["v"], tokens,
                             positions, temps, generator, cfg, write, view,
                             top_ps, top_ks, attend)


@torch.no_grad()
def paged_decode_steps(model, pool, tables, lengths, tokens, temps,
                       generator, cfg, n: int, top_ps=None, top_ks=None, *,
                       impl="auto"):
    """n chained decode steps against the block pool, as a loop on the
    device: each step feeds its sampled tokens to the next without a host
    sync. tables (slots, W) int32, lengths/tokens (slots,) int32 and
    temps (slots,) f32 live on the pool's (first shard's) device;
    ``temps=None`` samples greedily; a ``ShardedLlama`` runs as in
    ``_paged_decode_core``. Returns (tokens (n, slots) int32 on the
    device, pool); the caller syncs once per
    block when it copies the tokens to the host. Slots past their
    request produce discardable garbage in the trash block."""
    impl = resolve_attn_impl(impl, _parts(pool["k"])[0].device)
    outs = []
    toks = tokens
    for i in range(n):
        toks = _paged_decode_core(model, pool, tables, lengths + i, toks,
                                  temps, generator, cfg, top_ps, top_ks,
                                  impl=impl)
        outs.append(toks)
    return torch.stack(outs), pool


def _paged_verify_core(model, pool, tables, lengths, tokens, cfg):
    """Speculative verify against the block pool: score w in-flight
    tokens per slot (the last emitted one and up to w-1 drafts) in one
    forward, ``verify_tokens_core`` with the block-table write and
    ``paged_attention_verify`` plugged in (the JAX package's gather twin:
    the one-query kernel takes no multi-query rows), per shard on its kv
    heads for a ``ShardedLlama``. tokens (b, w) int32,
    column 0 at cache position ``lengths``; all w KVs are written through
    the table in place. A write past a slot's table clamps its block
    index into the table's last row (as the JAX package's clip does):
    within the full-horizon reservation such a write lands beyond the
    logical length, masked out of every attention and overwritten by the
    next real write, so a rejected draft needs no device rollback.
    Returns (b, w, vocab) f32 logits; row j is the distribution for
    position lengths+j+1."""
    from ray_tpu_torch.llm.model import verify_tokens_core
    from ray_tpu_torch.ops.paged_attention import paged_attention_verify
    b, wq = tokens.shape
    bs = _parts(pool["k"])[0].shape[2]
    w = tables.shape[1]
    hd = cfg.head_dim
    pos = lengths[:, None] + torch.arange(wq, dtype=lengths.dtype,
                                          device=lengths.device)[None]
    blk = torch.clamp(pos // bs, 0, w - 1).long()
    off = (pos % bs).long()
    phys = torch.take_along_dim(tables.long(), blk, dim=1)   # (b, wq)

    def write(ck, cv, k, v):    # k/v: (b, wq, kvh, hd)
        at = (phys.to(ck.device), off.to(ck.device))
        ck.index_put_(at, k.to(ck.dtype))
        cv.index_put_(at, v.to(cv.dtype))

    def attend(q, ck, cv, pos_grid):    # q: (b, wq, h, hd)
        qg = q.reshape(b, wq, ck.shape[2], -1, hd)
        o = paged_attention_verify(qg, ck, cv, tables.to(ck.device),
                                   pos_grid + 1)
        return o.reshape(b, wq, -1)

    return verify_tokens_core(model, pool["k"], pool["v"], tokens, lengths,
                              cfg, write, attend)


@torch.no_grad()
def paged_verify_steps(model, pool, tables, lengths, tokens, cfg):
    """One speculative verify round, the verify twin of
    ``paged_decode_steps``: tokens (b, w) int32 with w from the engine's
    verify-width buckets, tables (b, W) int32 and lengths (b,) int32 on
    the pool's (first shard's) device; a ``ShardedLlama`` runs as in
    ``_paged_decode_core``. Returns ((b, w, vocab) f32 logits on the
    device, pool); the pool is updated in place. Each call adds one to
    ``paged_verify_steps.launches`` (verify forwards, read by
    chip_smoke.py)."""
    logits = _paged_verify_core(model, pool, tables, lengths, tokens, cfg)
    paged_verify_steps.launches += 1
    return logits, pool


paged_verify_steps.launches = 0   # verify forwards, for chip_smoke.py
