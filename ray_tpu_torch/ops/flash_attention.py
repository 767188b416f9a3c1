"""Flash-attention forward: the hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``_fwd_kernel`` of
``ray_tpu/ops/pallas/flash_attention.py`` (driven by
``flash_attention_fwd``), inference path only: no lse output, no
backward (the backward pair belongs to the training slice).

The kernel (``csrc/flash_attention_fwd.cu``): one thread block per
(q tile of 64 rows, batch*head), a loop over 64-key tiles that stops at
the last tile the causal diagonal reaches, K/V tiles staged in shared
memory, scores and the online-softmax state in f32. Query head h reads
kv head h // (h / kvh) inside the kernel instead of a repeated K/V copy.

What bounds it on an H100: at prefill shapes (s = 64..512, d = 128) the
bytes are small (a 512-token Llama-3-8B layer moves ~10.5 MB, ~3 us at
3.35 TB/s) and the work is ~2 GFLOP, which the tensor cores would do in
~2 us. This first kernel multiplies with f32 FMA loops from shared
memory, so it is bound by FMA issue and shared-memory reads, far above
either bound; ``wgmma``/TMA tiles are the next step.

``mha_reference`` is the plain version: the CPU path of
``flash_attention`` and the yardstick the kernel is held against on the
card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, s, kv_heads, d) -> (b, s, num_heads, d) for GQA."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k
    if num_heads % kvh:
        raise ValueError(
            f"num_heads {num_heads} not divisible by kv_heads {kvh}")
    return torch.repeat_interleave(k, num_heads // kvh, dim=2)


def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: Optional[float] = None,
                  q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain attention, (b, s, h, d) layout, O(S^2) memory. ``q_offset``
    places the causal diagonal (query i attends keys <= i + q_offset;
    default sk - sq: queries are the last rows). Rows that keep no key
    give 0."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        diag = (sk - sq) if q_offset is None else int(q_offset)
        keep = torch.tril(keep, diagonal=diag)
    logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(keep.any(dim=-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """q: (b, sq, h, d); k/v: (b, sk, kvh, d) -> (b, sq, h, d) in q's
    dtype. On CUDA tensors the kernel runs (or this raises); on CPU
    tensors the plain version runs."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if h % kvh:
        raise ValueError(f"num_heads {h} not divisible by kv_heads {kvh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit")
    out = torch.empty_like(q)
    if sq == 0 or b == 0:
        return out
    scale = sm_scale if sm_scale is not None else d ** -0.5
    offset = (sk - sq) if q_offset is None else int(q_offset)
    fn = _build.kernel("flash_attention_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, kvh, d, offset, int(bool(causal)),
             float(scale), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0   # kernel launches, for chip_smoke.py


def work(b: int, sq: int, sk: int, h: int, kvh: int, d: int, itemsize: int,
         causal: bool = True, q_offset: Optional[int] = None) -> dict:
    """Bytes and operations one call needs at these shapes: q and o once,
    the keys/values the causal diagonal reaches once, and 4*d flops per
    kept (query, key) pair (QK^T and PV)."""
    offset = (sk - sq) if q_offset is None else int(q_offset)
    if causal:
        pairs = sum(max(0, min(sk, i + offset + 1)) for i in range(sq))
        keys = max(0, min(sk, sq + offset))
    else:
        pairs, keys = sq * sk, sk
    nbytes = itemsize * b * d * (2 * sq * h + 2 * keys * kvh)
    return {"bytes": nbytes, "flops": 4 * d * b * h * pairs}


__all__ = ["flash_attention_fwd", "mha_reference", "work"]
