"""Bytes and operations of one attention kernel call, from its shapes,
frozen here as the yardstick of the roofline metrics.

Each input is read once and each output written once, whatever a kernel
reads again; operations count only the (query, key) pairs the causal
mask keeps. The counts are those of the port's kernels at the time this
benchmark was written (``ops/flash_attention.py`` ``work``/``work_bwd``,
``ops/paged_attention.py`` ``work``).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(work: dict) -> float:
    """The least time the card could take: bytes over peak bandwidth or
    operations over the bf16 tensor-core peak, whichever is larger."""
    return max(work["bytes"] / PEAKS["hbm_bytes_per_s"],
               work["flops"] / PEAKS["bf16_flops_per_s"])


def _pairs(sq: int, sk: int, causal: bool) -> int:
    """Kept (query, key) pairs with the queries at the end of the keys."""
    if not causal:
        return sq * sk
    off = sk - sq
    # query i keeps min(sk, i + off + 1) keys
    full = max(0, min(sq, sk - off))
    return sum(min(sk, i + off + 1) for i in range(full)) + (sq - full) * sk


def flash_fwd(b: int, s: int, h: int, kvh: int, d: int, itemsize: int,
              with_lse: bool = True, causal: bool = True) -> dict:
    """K1 on (b, s) queries against s keys: q and o once, k and v once,
    lse (f32) once when written; 4*d flops per kept pair."""
    nbytes = itemsize * b * d * (2 * s * h + 2 * s * kvh)
    if with_lse:
        nbytes += 4 * b * h * s
    return {"bytes": nbytes, "flops": 4 * d * b * h * _pairs(s, s, causal)}


def flash_bwd_dkv(b: int, s: int, h: int, kvh: int, d: int, itemsize: int,
                  causal: bool = True, **_) -> dict:
    """K2: reads q, dO, k, v, lse and delta once, writes dK and dV;
    8*d flops per kept pair."""
    rows = itemsize * b * d * 2 * s * h + 2 * 4 * b * h * s
    kv = itemsize * b * d * 2 * s * kvh
    return {"bytes": rows + 2 * kv,
            "flops": 8 * d * b * h * _pairs(s, s, causal)}


def flash_bwd_dq(b: int, s: int, h: int, kvh: int, d: int, itemsize: int,
                 causal: bool = True, **_) -> dict:
    """K3: reads q, dO, k, v, lse and delta once, writes dQ; 6*d flops
    per kept pair."""
    rows = itemsize * b * d * 2 * s * h + 2 * 4 * b * h * s
    kv = itemsize * b * d * 2 * s * kvh
    return {"bytes": rows + kv + itemsize * b * d * s * h,
            "flops": 6 * d * b * h * _pairs(s, s, causal)}


def paged_decode(lengths, kvh: int, g: int, d: int, pool_itemsize: int,
                 q_itemsize: int, **_) -> dict:
    """K4 for one query per slot: every live K and V position once, the
    queries once and the f32 output once; 4*d flops per (query row, live
    position)."""
    live = int(sum(int(x) for x in lengths))
    b = len(lengths)
    nbytes = 2 * live * kvh * d * pool_itemsize + b * kvh * g * d * (
        q_itemsize + 4)
    return {"bytes": nbytes, "flops": 4 * d * kvh * g * live}


WORK = {"flash_fwd": flash_fwd, "flash_bwd_dkv": flash_bwd_dkv,
        "flash_bwd_dq": flash_bwd_dq, "paged_decode": paged_decode}
