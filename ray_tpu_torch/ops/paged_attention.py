"""Paged decode attention: the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``_decode_kernel`` of
``ray_tpu/ops/pallas/paged_attention.py`` (driven by
``paged_attention``): one-token GQA decode attention that walks each
slot's block table directly, so no gathered (slots, max_len) view of the
pool is ever built.

The kernel (``csrc/paged_attention.cu``): one thread block per
(kv head, slot), a loop over the slot's live table entries only
(j <= (length - 1) // bs) that reads ``tables[slot, j]`` itself and
stages that pool block's (bs, hd) K and V tiles for its head, read with
strides from the (num_blocks, bs, kvh, hd) layout. The g query rows of
the group stay in shared memory and registers; an f32 online softmax
divides once at the end, as the TPU kernel does.

What bounds it on an H100: it streams the live K/V bytes once, so the
least time is live bytes over 3.35 TB/s (8 slots at 1024 tokens,
Llama-3-8B: 33.5 MB, ~10 us per layer). This first kernel runs one block
per (slot, head) with unoverlapped tile loads, so at 8 slots it is
latency-bound: splitting each slot's walk across blocks and pipelining
the loads is the next step.

``paged_attention_reference`` is the plain version (the gather-then-
softmax math of ``ray_tpu.llm.model._gqa_attend_cached``): the CPU path
and the yardstick the kernel is held against on the card. The two divide
in different orders (the kernel after accumulating, the reference
before), so they agree to f32 rounding, and bitwise on integer
constructions with power-of-two lengths.
"""

from __future__ import annotations

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


@torch.no_grad()
def paged_attention(q, k_pool, v_pool, tables, lengths) -> torch.Tensor:
    """Single-token decode attention straight through block tables.
    Shapes as ``paged_attention_reference``; lengths count valid
    positions including the current token (>= 1). On CUDA tensors the
    kernel runs (or this raises); on CPU tensors the plain version runs.
    Table entries must be valid pool block ids (the engine's tables
    always are: unused entries point at the trash block 0)."""
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
    # the kernel computes in f32: the group's queries cross as f32 (a few
    # KB per step), as the TPU kernel upcasts them inside
    qf = q.float().contiguous()
    for name, t in (("q", qf), ("k_pool", k_pool), ("v_pool", v_pool),
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, kvh, g, hd, bs, tables.shape[1], _DTYPES[k_pool.dtype],
             stream)
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


__all__ = ["paged_attention", "paged_attention_reference", "work"]
