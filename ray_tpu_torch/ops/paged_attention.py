"""Paged decode attention: the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``_decode_kernel`` of
``ray_tpu/ops/pallas/paged_attention.py`` (driven by
``paged_attention``): one-token GQA decode attention that walks each
slot's block table directly, so no gathered (slots, max_len) view of the
pool is ever built.

The kernel (``csrc/paged_attention.cu``) splits each slot's walk across
blocks (flash-decoding): one thread block per (kv head, slot, split), a
split being ``span`` consecutive table entries (``split_span``, sized
from the table width so that the host never reads ``lengths``). A block
reads its ``tables[slot, j]`` itself, puts the loads of all of those
pool blocks' (bs, hd) K and V tiles for its head in flight at once
(``cp.async``, up to three stages of 64 positions, each computed as it
lands), keeps them in the pool's dtype in shared memory, and writes its
unnormalised f32 online-softmax partial (m, l, acc) to scratch that the
wrapper allocates. The last split block of each (slot, kv head) to
arrive, found through an arrival counter that it resets, adds the
partials in split order (bitwise deterministic) and divides once, l == 0
counting as 1 as the TPU kernel does. q goes in in its own dtype and is
upcast inside.

What bounds it on an H100: it streams the live K/V bytes once, at ~4
flops a byte (g 4), so the least time is live bytes over 3.35 TB/s (8
slots at 1024 tokens, Llama-3-8B: 33.5 MB, ~10 us per layer); at a few
slots the latency of the longest slot's walk sets its time, which the
splits cut into pieces that run side by side.

``paged_attention_reference`` is the plain version (the gather-then-
softmax math of ``ray_tpu.llm.model._gqa_attend_cached``): the CPU path
and the yardstick the kernel is held against on the card. The two divide
in different orders (the kernel after accumulating, the reference
before), so they agree to f32 rounding, and bitwise on integer
constructions with power-of-two lengths.
"""

from __future__ import annotations

import functools
import math

import torch

from ray_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPES = {(64, 8), (64, 16), (64, 32), (128, 8), (128, 16), (128, 32)}
_MAX_GROUP = 8
NEG_INF = -1e30


def paged_attention_reference(q, k_pool, v_pool, tables, lengths):
    """Gather-then-softmax: q (slots, kvh, g, hd); k/v pool one layer
    (num_blocks, bs, kvh, hd); tables (slots, width) int; lengths
    (slots,) int -> (slots, kvh, g, hd) float32."""
    b, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    w = tables.shape[1]
    t = tables.long()
    vk = k_pool[t].reshape(b, w * bs, kvh, hd).float()
    vv = v_pool[t].reshape(b, w * bs, kvh, hd).float()
    scores = torch.einsum("bkgd,blkd->bkgl", q.float(), vk) / math.sqrt(hd)
    mask = (torch.arange(w * bs, device=q.device)[None]
            < lengths.to(q.device)[:, None])
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgl,blkd->bkgd", probs, vv)


def paged_attention_verify(q, k_pool, v_pool, tables, lengths):
    """Multi-query verify attention through block tables, for
    speculative decoding: w in-flight queries per slot (the last emitted
    token and up to w-1 draft tokens), query j attending the cached
    history plus the draft tokens written ahead of it this round.

    q (slots, w, kvh, g, hd); k/v pool one layer (num_blocks, bs, kvh,
    hd); tables (slots, width) int; lengths (slots, w) int, valid
    positions per query including its own token (column j = cached + j
    + 1) -> (slots, w, kvh, g, hd) float32.

    The plain gather twin of ``ray_tpu.ops.pallas.paged_attention.
    paged_attention_verify``, which is jnp and no Pallas kernel: it
    gathers the table view once per layer, so one verify round pays one
    gather where w sequential decode steps walked the table w times.
    Exact-zero masking (NEG_INF, then softmax) keeps pool bytes beyond
    each query's mask out of its row. It runs as the same PyTorch ops on
    any device and counts no launches."""
    b, wq, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    w = tables.shape[1]
    t = tables.long()
    vk = k_pool[t].reshape(b, w * bs, kvh, hd).float()
    vv = v_pool[t].reshape(b, w * bs, kvh, hd).float()
    scores = torch.einsum("bwkgd,blkd->bwkgl", q.float(), vk) / math.sqrt(hd)
    mask = (torch.arange(w * bs, device=q.device)[None, None]
            < lengths.to(q.device)[:, :, None])           # (b, wq, w*bs)
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bwkgl,blkd->bwkgd", probs, vv)


# split blocks the grid aims at per SM (the kernel fits four at once): at
# 8 slots x 8 kv heads, width 64 and 132 SMs, 16 splits of 4 entries (one
# 64-position stage at block size 16), 1024 blocks before the splits past
# each slot's length exit
_BLOCKS_PER_SM = 8
# at most this many splits per (slot, kv head): the last block stages
# their (m, l) in its shared memory
_MAX_SPLITS = 256
# at most this many positions per split (the kernel's STAGES x TOK: three
# 64-position stages, all loaded at once), so a table holds at most
# _MAX_SPLITS x 192 = 49152 positions
_SPLIT_POSITIONS = 3 * 64


def split_span(slots: int, kvh: int, width: int, bs: int, sms: int) -> int:
    """Table entries per split block: enough splits per (slot, kv head)
    that slots x kvh x splits is at least ``_BLOCKS_PER_SM`` x ``sms``,
    at most one split per entry and ``_MAX_SPLITS`` splits, and at most
    ``_SPLIT_POSITIONS`` positions per split. From the table width alone,
    which the host knows, never from the lengths."""
    want = -(-_BLOCKS_PER_SM * sms // max(1, slots * kvh))
    span = -(-width // max(1, min(width, want, _MAX_SPLITS)))
    return min(span, _SPLIT_POSITIONS // bs)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split blocks' int32 arrival counters for launches on
    ``stream``: zero between launches (each launch's last block of a
    (slot, kv head) resets its own), so they are kept across calls, one
    set per stream so that launches on two streams never share one, and
    replaced by a larger zeroed set when a launch needs more."""
    c = _COUNTERS.get((device, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = c
    return c


@torch.no_grad()
def paged_attention(q, k_pool, v_pool, tables, lengths,
                    span: int | None = None) -> torch.Tensor:
    """Single-token decode attention straight through block tables.
    Shapes as ``paged_attention_reference``; lengths count valid
    positions including the current token (>= 1). On CUDA tensors the
    kernel runs (or this raises); on CPU tensors the plain version runs.
    Table entries must be valid pool block ids (the engine's tables
    always are: unused entries point at the trash block 0). ``span``,
    table entries per split block, defaults to ``split_span``'s; another
    span gives the same result to f32 rounding (chip_smoke.py times the
    spans against each other)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths)
    b, kvh, g, hd = q.shape
    nb, bs, kvh_p, hd_p = k_pool.shape
    if (kvh_p, hd_p) != (kvh, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
                         f" does not match q {tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {b} slots")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"kernel takes a float32 or bfloat16 pool, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if (hd, bs) not in _SHAPES or not 1 <= g <= _MAX_GROUP:
        raise ValueError(f"kernel takes (head_dim, block_size) in "
                         f"{sorted(_SHAPES)} and group <= {_MAX_GROUP}, "
                         f"got ({hd}, {bs}), group {g}")
    # q goes in in its own dtype (f32 or bf16) and is upcast inside
    qk = (q if q.dtype in _DTYPES else q.float()).contiguous()
    for name, t in (("q", qk), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    fn = _build.kernel("paged_attention")
    w = tables.shape[1]
    if span is None:
        span = split_span(b, kvh, w, bs, _sm_count(q.device))
    if not 1 <= span <= _SPLIT_POSITIONS // bs:
        raise ValueError(f"span {span}: a split holds 1 to "
                         f"{_SPLIT_POSITIONS // bs} entries at block size {bs}")
    nsplit = -(-w // span)
    if nsplit > _MAX_SPLITS:
        raise ValueError(f"table of {w} x {bs} positions in splits of {span} "
                         f"entries: the kernel takes at most {_MAX_SPLITS} "
                         "splits")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = counters = None
    if nsplit > 1:
        # the splits' (m, l) and acc partials, and their arrival counters
        part = torch.empty(b * kvh * nsplit * g * (hd + 2),
                           dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, b * kvh)
    with torch.cuda.device(q.device):   # the launch is the current device's
        err = fn(qk.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), lengths.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 out.data_ptr(), b, kvh, g, hd, bs, w, span,
                 _DTYPES[qk.dtype], _DTYPES[k_pool.dtype], stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0   # kernel launches, for chip_smoke.py


def work(lengths, kvh: int, g: int, hd: int, pool_itemsize: int,
         q_itemsize: int) -> dict:
    """Bytes and operations one call needs for these lengths: every live
    K and V position once, the queries once and the f32 output once;
    4*hd flops per (query row, live position)."""
    live = int(sum(int(x) for x in lengths))
    b = len(lengths)
    nbytes = (2 * live * kvh * hd * pool_itemsize
              + b * kvh * g * hd * (q_itemsize + 4))
    return {"bytes": nbytes, "flops": 4 * hd * kvh * g * live}


__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_verify", "split_span", "work"]
