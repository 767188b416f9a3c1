"""Flash attention: the hand-written CUDA kernels and their plain
versions.

Replaces the Pallas TPU kernels of ``ray_tpu/ops/pallas/flash_attention.py``:
``_fwd_kernel`` (K1, driven by ``flash_attention_fwd``, with the lse
output the training forward saves) and the backward pair ``_dkv_kernel``
(K2) and ``_dq_kernel`` (K3), driven by ``flash_attention_bwd``.

What bounds them on an H100: operations. At the training shape (b 1,
s 4096, 32/8 heads, d 128, causal) K1 does 137 GFLOP (0.139 ms at the
989 TF/s bf16 tensor-core rate), K2 275 and K3 206, against ~0.04-0.1 GB
moved; a 512-token prefill's K1 is 8.6 GFLOP and ~10.5 MB, where bytes
and launch latency weigh as much.

bf16, K1, K2 and K3 (``csrc/flash_attention_fwd.cu``,
``flash_attention_bwd.cu``, Hopper helpers in ``csrc/hopper.cuh``):
warp-specialised ``wgmma`` kernels. A producer warp streams bf16 tiles by
TMA into an mbarrier ring in the 128-byte-swizzled layout ``wgmma``
reads, while two consumer warpgroups multiply on the tensor cores: K1
owns a 128-row q tile and runs S = q'K^T, the online softmax in registers
and O += P V with P as a register operand; K2 owns a 128-key kv tile and
runs the products transposed (S^T = K q'^T, dP^T = V dO^T, dV += P^T dO,
dK += dS^T q'), summing the GQA group in registers without atomics; K3
owns a 128-row q tile and runs S = q'K^T, dP = dO V^T and dQ' += dS K
with dS as a register operand and K read MN-major, dQ' in registers over
the whole kv loop. All three launch the heaviest causal tiles first. P
(K1, K2) and dS (K2, K3) are rounded to bf16 before their second product,
as the TPU kernels do; the plain versions keep them in f32, and the
card's tolerances cover the difference (``tests/test_torch_flash_bf16.py``
holds the plain versions against the Pallas kernels and against the
kernels' roundings).

f32: plain f32 FMA kernels (tensor cores take f32 only as TF32, which
would break f32 parity), one block per q tile (K1, K3) or kv tile (K2)
looping over the other axis.

The wrappers fold sm_scale into q as the JAX wrapper does
(``fold_scale``; ``flash_attention.py:160``): a tensor op before the bf16
kernels, which TMA cannot scale in flight; the bf16 K1 and K2 then take
scale 1, and the bf16 K3 takes sm_scale itself, which it applies to dQ'
once; the f32 kernels fold q themselves. Query head h reads kv head
h // (h / kvh) inside every kernel instead of a repeated K/V copy.

Plain versions, the CPU path of each wrapper and the yardstick each
kernel is held against on the card: ``mha_reference`` (K1 without lse),
``flash_attention_fwd_reference`` (K1 with lse),
``flash_attention_bwd_dkv_reference``/``flash_attention_bwd_dq_reference``
(K2/K3) and ``flash_attention_bwd_reference`` (the whole backward).
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
                  segment_ids: Optional[torch.Tensor] = None,
                  q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain attention, (b, s, h, d) layout, O(S^2) memory. ``q_offset``
    places the causal diagonal (query i attends keys <= i + q_offset;
    default sk - sq: queries are the last rows). ``segment_ids`` (b, s)
    keeps only pairs within one segment (packed sequences; queries and
    keys share the ids, so sq == sk). Rows that keep no key give 0."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        diag = (sk - sq) if q_offset is None else int(q_offset)
        keep = torch.tril(keep, diagonal=diag)
    if segment_ids is not None:
        seg = segment_ids.to(q.device)
        keep = keep & (seg[:, :, None] == seg[:, None, :])[:, None]
    logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(keep.any(dim=-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _keep_mask(sq: int, sk: int, causal: bool, offset: int,
               device) -> torch.Tensor:
    """(sq, sk) bool: key j is kept for query i (j <= i + offset when
    causal)."""
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    return torch.tril(keep, diagonal=offset) if causal else keep


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q' = q * sm_scale rounded to q's dtype, as the kernels (and the
    TPU kernels) fold the scale into q; returned in f32."""
    return (q.float() * scale).to(q.dtype).float()


def fold_scale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q' = q * sm_scale rounded to q's dtype, the product taken in f32:
    the JAX wrapper's fold (``ray_tpu/ops/pallas/flash_attention.py:160``)
    as one elementwise op."""
    return q * scale


def flash_attention_fwd_reference(q, k, v, *, causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  q_offset: Optional[int] = None):
    """K1's arithmetic with the lse output, written out: s = q'k^T with
    q' = q * sm_scale rounded to q's dtype, an f32 softmax, o in q's
    dtype and lse = logsumexp_j s_ij, (b, h, sq) f32. A row that keeps no
    key gives o = 0 and lse = -1e30, as the kernel does."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    offset = (sk - sq) if q_offset is None else int(q_offset)
    keep = _keep_mask(sq, sk, causal, offset, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", _scaled_q(q, scale),
                     _repeat_kv(k, h).float())
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, dim=-1)
    rows = keep.any(dim=-1)
    p = torch.where(rows[:, None], torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    o = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(v, h).float())
    lse = torch.where(rows, lse, torch.full_like(lse, -1e30))
    return o.to(q.dtype), lse


def _check_operands(names, tensors, like: torch.Tensor) -> None:
    """The kernels take contiguous, 16-byte aligned tensors of ``like``'s
    dtype (float32 or bfloat16) on ``like``'s device."""
    if like.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16 operands of one "
                        f"dtype, got {like.dtype}")
    for name, t in zip(names, tensors):
        if t.dtype != like.dtype:
            raise TypeError(f"kernel takes {name} of one dtype with q, got "
                            f"{t.dtype} and {like.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} on {t.device}, q on {like.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def _folded(q: torch.Tensor, scale: float):
    """The bf16 kernels take q' = ``fold_scale(q, scale)`` and scale 1;
    the f32 kernels fold q themselves."""
    if q.dtype == torch.bfloat16:
        return fold_scale(q, scale), 1.0
    return q, scale


def _check_shapes(q, k, v) -> None:
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if h % kvh:
        raise ValueError(f"num_heads {h} not divisible by kv_heads {kvh}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, got {d}")


def _check_lse(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    b, sq, h, _ = q.shape
    if t.shape != (b, h, sq) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be (b, h, sq) = {(b, h, sq)} "
                         f"float32, got {tuple(t.shape)} {t.dtype}")
    if t.device != q.device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        q_offset: Optional[int] = None,
                        with_lse: bool = False):
    """q: (b, sq, h, d); k/v: (b, sk, kvh, d) -> o (b, sq, h, d) in q's
    dtype, or ``(o, lse)`` with ``with_lse`` (lse (b, h, sq) f32, the
    backward's residual). On CUDA tensors the kernel runs (or this
    raises); on CPU tensors the plain version runs."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_fwd_reference(
                q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    _check_shapes(q, k, v)
    _check_operands(("q", "k", "v"), (q, k, v), q)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if sq == 0 or b == 0:
        return (out, lse) if with_lse else out
    scale = sm_scale if sm_scale is not None else d ** -0.5
    offset = (sk - sq) if q_offset is None else int(q_offset)
    fn = _build.kernel("flash_attention_fwd")
    q, scale = _folded(q, scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the launch is the current device's
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 b, sq, sk, h, kvh, d, offset, int(bool(causal)),
                 float(scale), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if with_lse:
        flash_attention_fwd.lse_launches += 1
        return out, lse
    return out


# kernel launches, for chip_smoke.py; lse_launches counts those of them
# that wrote lse (the training forward)
flash_attention_fwd.launches = 0
flash_attention_fwd.lse_launches = 0


# --- backward (K2, K3) ------------------------------------------------------


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o) in f32, (b, h, sq): the backward's per-row
    term, a plain tensor op outside the kernels as in the JAX package."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, scale, causal):
    """The backward's materialised (b, h, sq, sk) f32 p and dS, with the
    causal diagonal at sk - sq; p is 0 off the kept pairs."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    keep = _keep_mask(sq, sk, causal, sk - sq, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", _scaled_q(q, scale),
                     _repeat_kv(k, h).float())
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      _repeat_kv(v, h).float())
    return p, p * (dp - delta[..., None])


def _group_sum(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(b, s, h, d) per query head -> (b, s, kvh, d): the GQA sum over
    the query heads that share a kv head."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kvh, h // kvh, d).sum(3)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, *,
                                      sm_scale: Optional[float] = None,
                                      causal: bool = True):
    """K2's arithmetic written out: dV = p^T dO, dK = dS^T q', each
    summed over the query heads of its kv head, in k's dtype."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    kvh = k.shape[2]
    dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do.float()), kvh)
    dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds,
                                 _scaled_q(q, scale)), kvh)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, *,
                                     sm_scale: Optional[float] = None,
                                     causal: bool = True):
    """K3's arithmetic written out: dQ = sm_scale * dS k, rounded once to
    q's dtype."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      _repeat_kv(k, q.shape[2]).float()) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_reference(q, k, v, o, do, lse, *,
                                  sm_scale: Optional[float] = None,
                                  causal: bool = True):
    """The whole backward's plain version -> (dq, dk, dv)."""
    delta = attention_delta(o, do)
    kw = dict(sm_scale=sm_scale, causal=causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _bwd_args(q, k, v, do, lse, delta):
    """Check a backward kernel's operands; -> the shared C arguments."""
    _check_shapes(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _check_operands(("q", "k", "v", "do"), (q, k, v, do), q)
    _check_lse("lse", lse, q)
    _check_lse("delta", delta, q)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if max(b, h) > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit")
    return (b, sq, sk, h, kvh, d, sk - sq)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *,
                            sm_scale: Optional[float] = None,
                            causal: bool = True):
    """K2: (dk, dv) in k's dtype and layout. q/do (b, sq, h, d), k/v
    (b, sk, kvh, d), lse/delta (b, h, sq) f32; the causal diagonal at
    sk - sq. On CUDA tensors the kernel runs (or this raises); on CPU
    tensors the plain version runs."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(
            q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal)
    dims = _bwd_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if 0 in q.shape or 0 in k.shape:
        return dk.zero_(), dv.zero_()
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    fn = _build.kernel("flash_attention_bwd_dkv")
    q, scale = _folded(q, scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), *dims, int(bool(causal)), float(scale),
                 _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *,
                           sm_scale: Optional[float] = None,
                           causal: bool = True):
    """K3: dq in q's dtype and layout (arguments as for
    ``flash_attention_bwd_dkv``). On CUDA tensors the kernel runs (or
    this raises); on CPU tensors the plain version runs."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(
            q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal)
    dims = _bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if 0 in q.shape or 0 in k.shape:
        return dq.zero_()
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    fn = _build.kernel("flash_attention_bwd_dq")
    if q.dtype == torch.bfloat16:
        q = fold_scale(q, scale)   # the kernel applies scale to dQ' only
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
                 int(bool(causal)), float(scale), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dkv.launches = 0   # kernel launches, for chip_smoke.py
flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, o, do, lse, *,
                        sm_scale: Optional[float] = None,
                        causal: bool = True):
    """The attention backward from the forward's residuals (q, k, v, o,
    lse) and the output cotangent do -> (dq, dk, dv): delta as a tensor
    op, then K2 and K3 on CUDA tensors (or this raises); the plain
    versions on CPU tensors."""
    delta = attention_delta(o, do)
    kw = dict(sm_scale=sm_scale, causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def work(b: int, sq: int, sk: int, h: int, kvh: int, d: int, itemsize: int,
         causal: bool = True, q_offset: Optional[int] = None,
         with_lse: bool = False) -> dict:
    """Bytes and operations one call needs at these shapes: q and o once,
    the keys/values the causal diagonal reaches once, lse (f32) once when
    written, and 4*d flops per kept (query, key) pair (QK^T and PV)."""
    offset = (sk - sq) if q_offset is None else int(q_offset)
    if causal:
        pairs = sum(max(0, min(sk, i + offset + 1)) for i in range(sq))
        keys = max(0, min(sk, sq + offset))
    else:
        pairs, keys = sq * sk, sk
    nbytes = itemsize * b * d * (2 * sq * h + 2 * keys * kvh)
    if with_lse:
        nbytes += 4 * b * h * sq
    return {"bytes": nbytes, "flops": 4 * d * b * h * pairs}


def work_bwd(b: int, sq: int, sk: int, h: int, kvh: int, d: int,
             itemsize: int, causal: bool = True) -> dict:
    """Bytes and operations of K2 and K3 at these shapes (the causal
    diagonal at sk - sq, which every key reaches): each reads q, dO, k,
    v, lse and delta (f32) once; K2 writes dK and dV, K3 writes dQ. Per
    kept (query, key) pair K2 does 8*d flops (q'k^T, dO v^T, p^T dO,
    dS^T q') and K3 6*d (q'k^T, dO v^T, dS k)."""
    pairs = work(b, sq, sk, h, kvh, d, itemsize, causal)["flops"] // (4 * d)
    rows = itemsize * b * d * 2 * sq * h + 2 * 4 * b * h * sq
    kv = itemsize * b * d * 2 * sk * kvh     # k, v in; dK, dV out
    return {"dkv": {"bytes": rows + 2 * kv, "flops": 8 * d * pairs},
            "dq": {"bytes": rows + kv + itemsize * b * d * sq * h,
                   "flops": 6 * d * pairs}}


__all__ = ["attention_delta", "flash_attention_bwd",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "fold_scale", "mha_reference",
           "work", "work_bwd"]
