"""Chunked ring allreduce over dag channels: the collective plane's
bandwidth-optimal path.

Replaces the star reduce for N>2 participants (reference for the shape:
NCCL's ring allreduce; the papers behind this PR: The Big Send-off,
arxiv 2504.18658 — chunked, pipelined collectives are what make
large-scale gradient exchange performant — and EQuARX, arxiv 2506.17615
— block-quantized allreduce recovers most of the interconnect bandwidth
with negligible quality loss). Topology: rank r owns one directed edge
to rank (r+1)%N — any mix of ShmRingChannel (same host) and TcpChannel
(cross host) works, the engine only needs write/read_with/slot_bytes.

A round has three phases:

1. **Header relay** (N-1 small frames): every participant sends a header
   carrying its layout signature — or the ERROR frame it entered the
   round with — and forwards whatever it received. After N-1 steps every
   rank holds every header, so an ERROR injected at ANY rank reaches ALL
   ranks in one round (no deadlock, channels stay aligned for the next
   round), and layout mismatches turn into the same deterministic error
   everywhere instead of a garbled reduce.
2. **Reduce-scatter** (N-1 steps): the flattened value is split into N
   segments, segments into chunks of ``chunk_bytes``; at step s rank r
   sends segment (r-s)%N chunk-by-chunk while receiving and accumulating
   segment (r-s-1)%N — the chunk pipelining: chunk k+1 is being copied
   into the ring while the consumer reduces chunk k. Accumulation is
   fused (np.add(src, incoming, out=buf)) and always happens in a
   float32-or-wider wire dtype, so low-precision inputs neither overflow
   nor drift across rounds. Per-participant traffic is O(S), independent
   of N — the star root's O(N*S) ingress+egress is gone.
3. **Allgather** (N-1 steps): each rank broadcasts the segment it now
   owns; received frames are forwarded VERBATIM (quantized payloads are
   not re-quantized hop by hop), so every rank reconstructs bitwise
   identical results — SPMD training state cannot diverge.

Opt-in int8 block quantization (``quantize="int8"``): each chunk ships
as [per-256-element float32 scales | int8 payload] — about 26% of the
fp32 wire bytes. The elementwise error of one quantization event is
bounded by scale/2 = max|block|/254; partial sums are requantized once
per reduce-scatter hop and the final value once, so a round's total
bound is (N*max_scale)/2 — exported per round as the
``allreduce_quant_error`` gauge. Accumulators stay float32/float64, so
the error does not compound across rounds.

Every round is traced (``_RingTrace``): round-level spans by default
(collective id, op, bytes, codec, send/recv-wait/header timing, train
step), per-chunk spans at ``collective_trace_level="chunk"`` — all in
the bounded "collective" event category so ``timeline(all_nodes=True)``
renders per-rank ring lanes with cross-rank flow edges. Straggler
attribution piggybacks each rank's recv-wait on the next round's
header relay (zero extra frames -> the ``allreduce_straggler_rank``
gauge), and a bounded flight recorder dumps the last K rounds' timing
to JSON when a round dies, attaching the path to the raised exception.

Phases 2 and 3 are ALSO standalone collective ops
(``RingReducer.reduce_scatter`` / ``RingReducer.allgather``, surfaced
through ``_Collective`` and the train plane): reduce-scatter hands each
rank its owned contiguous shard of the flat reduced value — the ZeRO-1
unit (arxiv 2004.13336: shard the weight update and optimizer state
across replicas) — and allgather reassembles shards into the full
pytree, with an opt-in ``wire_dtype="bfloat16"`` cast codec (half the
fp32 bytes, one rounding event, owner round-tripped so results stay
bitwise identical across ranks). The fused allreduce round is exactly
these two phases back to back over one buffer.

The port's copy of ``ray_tpu/dag/ring.py``, numpy on the host as the
reference is. One device differs: the reference's bfloat16 wire dtype is
ml_dtypes', which the port may not import. Here ``"bfloat16"`` resolves
to ``BFLOAT16``, which ships a float32 buffer as the top 16 bits of each
value's bit pattern rounded to nearest even (NaN kept NaN): the frames,
the rounding and the round-tripped values are bitwise those of
ml_dtypes' cast (``bf16_bits`` / ``bf16_values``). The train plane
stages torch tensors into numpy before they reach a ring
(train/collective.py ``_stage``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.dag.channel import (DATA, ERROR, ChannelAttachRefused,
                                 ChannelClosed, ChannelTimeout,
                                 attach_channel, chaos_mark_retry)
from ray_tpu_torch.runtime.serialization import dumps_oob, loads_oob
from ray_tpu_torch.util import events, forensics

_UNSET = object()              # "use the constructor default" sentinel
DEFAULT_CHUNK_BYTES = 1 << 20
QUANT_BLOCK = 256           # elements per int8/int4 quantization block
_QUANTIZE_MODES = (None, "int8", "int4")


class RingPeerDead(Exception):
    """A ring neighbor stopped responding (peer death / teardown):
    terminal for the group — bounded reads surfaced it within
    timeout_s on every surviving participant."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class RingProtocolError(Exception):
    """A frame kind the protocol cannot produce arrived mid-phase:
    the channels are desynced beyond repair for this group."""


class _AbortedOp(Exception):
    """Internal: ``RingReducer.abort()`` interrupted a blocked channel
    op — surfaced to callers as RingPeerDead with a reshape message."""


# How finely blocked ring waits are sliced so abort() can interrupt
# them: the worst-case extra latency an aborted participant pays, and
# the wakeup period while blocked (waits with data ready return
# immediately; the slicing only costs when genuinely stalled).
_ABORT_SLICE_S = 0.25


def allreduce_metrics() -> dict:
    """Get-or-create the collective plane's series (shared process
    registry; worker processes push them to the head via
    util/metrics.push_loop, so the head /metrics serves cluster-wide
    allreduce telemetry like the other PR-2 aggregated series).

      allreduce_round_s       wall time of one full allreduce round
      reduce_scatter_round_s  wall time of one STANDALONE
                              reduce-scatter round (headers + N-1 steps)
      allgather_round_s       wall time of one STANDALONE allgather
                              round (headers + N-1 steps)
      collective_recv_wait_s  per-round blocked-on-predecessor time
                              (straggler attribution input; rank tag)
      allreduce_straggler_rank  rank that dominated the previous
                              round's critical path (see _RingTrace)
      allreduce_bytes_total   wire bytes this participant wrote
      allreduce_quant_error   elementwise error bound of the last
                              round per wire codec ({codec=int8|int4|
                              bf16|fp32}): (N * max_block_scale) / 2
                              where scale = max|block|/127 (int8) or
                              max|block|/7 (int4); 0 for the lossless
                              and cast codecs
      allreduce_hier_inter_bytes_total  wire bytes written by this
                              participant on the CROSS-NODE (inter)
                              leg of hierarchical collectives — the
                              number the ring-of-rings exists to
                              shrink (~1/ranks-per-node of the flat
                              ring's cross-node traffic)
      collective_bcast_round_s  wall time of one intra-node broadcast
                              round (the hierarchical fan-out phase)
      collective_tuner_regime   impl the in-situ auto-tuner chose for
                              the last collective payload: 0 = star,
                              1 = flat ring, 2 = hierarchical
      allreduce_bucket_overlap_s  per gradient sync, the staging time
                              that was hidden under in-flight ring
                              rounds by bucketed sync (train plane)
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "round": m.Histogram(
            "allreduce_round_s",
            "Wall time of one collective-plane allreduce round "
            "(header relay + reduce-scatter + allgather)"),
        "rs_round": m.Histogram(
            "reduce_scatter_round_s",
            "Wall time of one standalone reduce-scatter round "
            "(header relay + N-1 pipelined chunk steps; the ZeRO "
            "gradient-shard sync)"),
        "ag_round": m.Histogram(
            "allgather_round_s",
            "Wall time of one standalone allgather round (header "
            "relay + N-1 pipelined chunk steps; the ZeRO parameter "
            "reassembly)"),
        "bytes": m.Counter(
            "allreduce_bytes_total",
            "Wire bytes written by this participant across collective "
            "rounds (headers + chunk frames; allreduce, reduce-scatter "
            "and allgather all meter here)"),
        "recv_wait": m.Histogram(
            "collective_recv_wait_s",
            "Time this rank spent BLOCKED waiting on its "
            "ring-predecessor per collective round: the first header "
            "read (direct wait for the predecessor to enter) plus all "
            "data-phase reads — header RELAY waits are excluded, they "
            "smear a late entrant's delay over every rank. The "
            "cross-rank argmax is the straggler signal: the rank "
            "AFTER the straggler waits longest. Tagged with this "
            "participant's rank",
            tag_keys=("rank",)),
        "straggler": m.Gauge(
            "allreduce_straggler_rank",
            "Rank whose slowness dominated the PREVIOUS collective "
            "round's critical path — computed identically on every "
            "rank from the recv-wait map each participant piggybacks "
            "on the next round's header relay (zero extra frames). "
            "-1 when no rank's wait dominated (healthy round); unset "
            "until a full round of attribution data exists"),
        "quant_err": m.Gauge(
            "allreduce_quant_error",
            "Elementwise error bound of the last round over the "
            "quantization events this participant OBSERVED (frames "
            "sent or received), labelled by wire codec "
            "(codec=int8|int4|bf16|fp16|fp32): (N*max_scale)/2, "
            "scale = max|block|/127 (int8) or max|block|/7 (int4). "
            "Exact when gradient magnitudes are comparable across "
            "ranks; partial sums quantized at non-adjacent hops can "
            "exceed it under cross-rank magnitude skew with "
            "cancellation. +inf when a non-finite gradient was "
            "NaN-poisoned through the wire; 0 for cast and fp32 "
            "rounds",
            tag_keys=("codec",)),
        "hier_inter_bytes": m.Counter(
            "allreduce_hier_inter_bytes_total",
            "Wire bytes this participant wrote on the cross-node "
            "(inter) leg of hierarchical collectives — the traffic "
            "the ring-of-rings shrinks to ~1/ranks-per-node of the "
            "flat ring's cross-node bytes"),
        "bc_round": m.Histogram(
            "collective_bcast_round_s",
            "Wall time of one intra-node broadcast round (header "
            "relay + pipelined chunk forwarding from the node "
            "leader; the hierarchical fan-out phase)"),
        "tuner_regime": m.Gauge(
            "collective_tuner_regime",
            "Impl the in-situ collective auto-tuner chose for the "
            "last payload it was consulted about: 0 = star, 1 = flat "
            "ring, 2 = hierarchical (unset until the first tuned "
            "decision)"),
        "bucket_overlap": m.Histogram(
            "allreduce_bucket_overlap_s",
            "Per bucketed gradient sync: host staging time that was "
            "hidden under in-flight ring rounds (the compute/comm "
            "overlap the bucket pipeline creates)"),
    }


# --- pytree flatten/unflatten (host plane: no jax import) ----------------


def _flatten(value) -> Tuple[List[np.ndarray], Any, tuple]:
    """(leaves, rebuild, sig): rebuild(iter_of_arrays) reconstructs the
    pytree; sig is a picklable, comparable structure descriptor —
    participants whose sigs differ cannot be reduced together."""
    leaves: List[np.ndarray] = []
    sig: List[tuple] = []

    def walk(v):
        if isinstance(v, dict):
            keys = list(v)
            sig.append(("dict", tuple(str(k) for k in keys)))
            fns = [walk(v[k]) for k in keys]
            t = type(v)

            def rb(it, keys=keys, fns=fns, t=t):
                out = {k: f(it) for k, f in zip(keys, fns)}
                return out if t is dict else t(out)
            return rb
        if isinstance(v, tuple) and hasattr(v, "_fields"):  # NamedTuple
            sig.append(("namedtuple", tuple(v._fields)))
            fns = [walk(x) for x in v]
            t = type(v)

            def rb(it, fns=fns, t=t):
                return t(*(f(it) for f in fns))
            return rb
        if isinstance(v, (list, tuple)):
            sig.append(("seq", type(v).__name__, len(v)))
            fns = [walk(x) for x in v]
            t = type(v)

            def rb(it, fns=fns, t=t):
                return t(f(it) for f in fns)
            return rb
        a = np.asarray(v)
        scalar = not isinstance(v, np.ndarray) and a.ndim == 0
        sig.append(("leaf", a.shape, a.dtype.str))
        leaves.append(a)

        def rb(it, scalar=scalar):
            out = next(it)
            return out.item() if scalar else out
        return rb

    rebuild = walk(value)
    return leaves, rebuild, tuple(sig)


def accumulation_dtype(dt: np.dtype, op: str) -> Optional[np.dtype]:
    """THE low-precision promotion policy, shared by the star's
    per-leaf reduce (runtime._tree_reduce) and the ring's wire dtype
    so the N<=2 fallback and the ring agree numerically. None = reduce
    in the input dtype. sum over sub-64-bit ints accumulates in int64;
    mean over integers accumulates in float64 (and the RESULT stays
    float64, matching numpy's int/len division — means of ints must
    not truncate); sub-32-bit floats (fp16, and bfloat16/fp8 which
    register as kind 'V') accumulate in float32."""
    if op not in ("sum", "mean"):
        return None              # max/min cannot overflow
    if dt.kind in "iub":
        if op == "mean":
            # int64/uint64 divisions already yield float64 stepwise
            return np.dtype(np.float64) if dt.itemsize < 8 else None
        return np.dtype(np.int64) if dt.itemsize < 8 else None
    if dt.kind == "f":
        return np.dtype(np.float32) if dt.itemsize < 4 else None
    if dt.kind == "V":           # ml_dtypes floats
        try:
            if np.finfo(dt).bits < 32:
                return np.dtype(np.float32)
        except ValueError:
            pass
    return None


def _keeps_wide(dt: np.dtype, op: str) -> bool:
    """True when the reduced result stays in the accumulation dtype
    instead of casting back: integer means are float64 results (the
    pre-ring star semantics; casting back would truncate)."""
    return op == "mean" and dt.kind in "iub"


def _wire_dtype(dtypes: List[np.dtype], op: str) -> np.dtype:
    rt = np.result_type(*dtypes) if dtypes else np.dtype(np.float32)
    p = accumulation_dtype(rt, op)
    if p is not None:
        return p
    if rt.kind in "iub":         # 64-bit ints
        return np.dtype(np.float64) if op == "mean" else rt
    if rt.kind in "cf":
        return rt
    try:                          # ml_dtypes floats >= 32 bits
        info = np.finfo(rt)
    except ValueError:
        raise TypeError(f"cannot ring-reduce dtype {rt}")
    return np.dtype(np.float32) if info.bits <= 32 else np.dtype(np.float64)


# --- int8 block quantization (EQuARX-style wire format) ------------------


def _quantize(x: np.ndarray) -> Tuple[bytearray, float]:
    """[nblocks float32 scales | n int8] — returns (frame, max_scale).
    Per-block scale = max|block|/127, so |q| <= 127 without clipping
    and the per-element dequantization error is bounded by scale/2.
    All-zero blocks ship scale 0 (exact). Blocks containing NaN/Inf
    ship scale NaN — dequantization NaN-poisons the whole block, so a
    diverged gradient SURFACES like it would unquantized instead of
    silently becoming finite garbage; max_scale reports +inf."""
    n = x.size
    nb = -(-n // QUANT_BLOCK)
    xb = np.zeros(nb * QUANT_BLOCK, np.float32)
    xb[:n] = x
    xb = xb.reshape(nb, QUANT_BLOCK)
    absmax = xb.__abs__().max(axis=1)
    finite = np.isfinite(absmax)
    div = np.where(finite & (absmax > 0.0), absmax / 127.0,
                   np.float32(1.0)).astype(np.float32)
    q = np.rint(np.where(finite[:, None], xb, np.float32(0.0))
                / div[:, None]).astype(np.int8)
    scales = np.where(finite,
                      np.where(absmax > 0.0, absmax / 127.0,
                               np.float32(0.0)),
                      np.float32(np.nan)).astype(np.float32)
    if not n:
        max_scale = 0.0
    elif finite.all():
        max_scale = float(absmax.max()) / 127.0
    else:
        max_scale = float("inf")
    frame = bytearray(4 * nb + n)
    frame[:4 * nb] = scales.tobytes()
    frame[4 * nb:] = q.reshape(-1)[:n].tobytes()
    return frame, max_scale


def _dequantize(frame, n: int) -> np.ndarray:
    nb = -(-n // QUANT_BLOCK)
    scales = np.frombuffer(frame, np.float32, nb)
    q = np.frombuffer(frame, np.int8, n, offset=4 * nb)
    out = np.zeros(nb * QUANT_BLOCK, np.float32)
    out[:n] = q
    out = out.reshape(nb, QUANT_BLOCK)
    out *= scales[:, None]
    # NaN scales must poison the ENTIRE block (q==0 elements included:
    # 0 * nan is already nan, so the multiply above covers every lane)
    return out.reshape(-1)[:n]


def _scales_max(frame, n: int) -> float:
    """Largest block scale carried by a received quantized frame —
    folded into the error-bound gauge so the bound reflects OTHER
    ranks' quantization events (their gradient magnitudes), not just
    this rank's own."""
    nb = -(-n // QUANT_BLOCK)
    if not nb:
        return 0.0
    m = float(np.frombuffer(frame, np.float32, nb).max())
    return m if np.isfinite(m) else float("inf")


def _quantize4(x: np.ndarray) -> Tuple[bytearray, float]:
    """[nblocks float32 scales | ceil(n/2) packed bytes] — two 4-bit
    two's-complement values per byte (even element in the low nibble),
    per-block scale = max|block|/7 so |q| <= 7 without clipping and
    the per-element dequantization error is bounded by scale/2. The
    zero / NaN semantics match ``_quantize``: all-zero blocks ship
    scale 0 (exact), non-finite blocks ship scale NaN (the whole block
    NaN-poisons on decode; max_scale reports +inf)."""
    n = x.size
    nb = -(-n // QUANT_BLOCK)
    xb = np.zeros(nb * QUANT_BLOCK, np.float32)
    xb[:n] = x
    xb = xb.reshape(nb, QUANT_BLOCK)
    absmax = xb.__abs__().max(axis=1)
    finite = np.isfinite(absmax)
    div = np.where(finite & (absmax > 0.0), absmax / 7.0,
                   np.float32(1.0)).astype(np.float32)
    q = np.rint(np.where(finite[:, None], xb, np.float32(0.0))
                / div[:, None]).astype(np.int8).reshape(-1)[:n]
    # pack pairs into bytes: QUANT_BLOCK is even, so only the tail of
    # an odd-length payload pads — the pad nibble is 0 and never read
    if n % 2:
        q = np.concatenate([q, np.zeros(1, np.int8)])
    u = q.view(np.uint8) & 0x0F
    packed = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    scales = np.where(finite,
                      np.where(absmax > 0.0, absmax / 7.0,
                               np.float32(0.0)),
                      np.float32(np.nan)).astype(np.float32)
    if not n:
        max_scale = 0.0
    elif finite.all():
        max_scale = float(absmax.max()) / 7.0
    else:
        max_scale = float("inf")
    frame = bytearray(4 * nb + (n + 1) // 2)
    frame[:4 * nb] = scales.tobytes()
    frame[4 * nb:] = packed.tobytes()
    return frame, max_scale


def _dequantize4(frame, n: int) -> np.ndarray:
    nb = -(-n // QUANT_BLOCK)
    scales = np.frombuffer(frame, np.float32, nb)
    packed = np.frombuffer(frame, np.uint8, (n + 1) // 2,
                           offset=4 * nb)
    u = np.empty(2 * packed.size, np.uint8)
    u[0::2] = packed & 0x0F
    u[1::2] = packed >> 4
    # sign-extend the 4-bit two's-complement nibbles
    q = ((u.astype(np.int16) ^ 8) - 8).astype(np.float32)
    out = np.zeros(nb * QUANT_BLOCK, np.float32)
    out[:n] = q[:n]
    out = out.reshape(nb, QUANT_BLOCK)
    out *= scales[:, None]
    # NaN scales poison the ENTIRE block, same as _dequantize
    return out.reshape(-1)[:n]


# --- wire codecs ---------------------------------------------------------
#
# A codec transforms chunk frames on the wire while accumulation stays
# in the float32-or-wider buffer dtype: `encode` turns a buffer slice
# into the frame that ships, `decode` turns a received frame back into
# the accumulation dtype. Two codecs exist: int8 block quantization
# (above) and a plain low-precision cast (bfloat16/float16 — half the
# fp32 bytes, no per-block scales). The allgather phase forwards
# ENCODED frames verbatim and the segment owner round-trips its own
# copy, so every rank reconstructs bitwise identical results whichever
# codec is active.


class _Int8Codec:
    tag = "int8"

    def __init__(self):
        self.max_scale = 0.0     # feeds the allreduce_quant_error gauge

    def encode(self, arr: np.ndarray) -> bytes:
        frame, smax = _quantize(arr)
        self.max_scale = max(self.max_scale, smax)
        return bytes(frame)

    def decode(self, frame, n: int, wire: np.dtype) -> np.ndarray:
        self.max_scale = max(self.max_scale, _scales_max(frame, n))
        out = _dequantize(frame, n)
        return out if wire == np.float32 else out.astype(wire)


class _Int4Codec:
    """Two quantized values per byte with per-block scales — ~12.9% of
    the fp32 wire bytes (4-bit payload + f32 scales per 256 elements).
    Coarser than int8 (15 levels per block), so gradient sync with
    this codec NEEDS error-feedback accumulation (train/collective.py)
    to stay convergence-safe; the bound rides the same
    ``allreduce_quant_error`` gauge under {codec=int4}."""

    tag = "int4"

    def __init__(self):
        self.max_scale = 0.0     # feeds the allreduce_quant_error gauge

    def encode(self, arr: np.ndarray) -> bytes:
        frame, smax = _quantize4(arr)
        self.max_scale = max(self.max_scale, smax)
        return bytes(frame)

    def decode(self, frame, n: int, wire: np.dtype) -> np.ndarray:
        self.max_scale = max(self.max_scale, _scales_max(frame, n))
        out = _dequantize4(frame, n)
        return out if wire == np.float32 else out.astype(wire)


class _Bfloat16Wire:
    """The bfloat16 wire dtype without ml_dtypes: a value is the top 16
    bits of its float32 pattern, rounded to nearest even, held in a
    ``uint16``. ``str()`` is ``"bfloat16"`` and ``.str`` numpy's
    ``"<V2"``, as for ml_dtypes' dtype, so options signatures and codec
    tags read the same on both packages."""

    name = "bfloat16"
    str = "<V2"
    kind = "V"
    itemsize = 2

    def __str__(self) -> str:
        return "bfloat16"

    def __repr__(self) -> str:
        return "dtype(bfloat16)"

    def __reduce__(self):
        return "BFLOAT16"      # pickles as the module's singleton


BFLOAT16 = _Bfloat16Wire()


def bf16_bits(x) -> np.ndarray:
    """bfloat16 bit patterns (``uint16``) of ``x``, bitwise those of
    ml_dtypes' cast: wider floats round to float32 first (as ml_dtypes
    does), then to nearest even on the float32 pattern; overflow rounds
    to inf; every NaN becomes the quiet NaN of its sign."""
    with np.errstate(over="ignore"):      # beyond f32: inf, as ml_dtypes
        f = np.ascontiguousarray(x, dtype=np.float32)
    u = f.view(np.uint32)
    half = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    out = ((u + half) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        out[nan] = np.where(u[nan] >> np.uint32(31), np.uint16(0xFFC0),
                            np.uint16(0x7FC0))
    return out


def bf16_values(bits) -> np.ndarray:
    """float32 values of bfloat16 bit patterns (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def wire_roundtrip(arr: np.ndarray, wdt) -> np.ndarray:
    """``arr`` cast to the wire dtype ``wdt`` and back to its own dtype:
    the one rounding event of a cast codec (the reference's
    ``arr.astype(wdt).astype(arr.dtype)``)."""
    if wdt is BFLOAT16:
        return bf16_values(bf16_bits(arr)).astype(arr.dtype, copy=False)
    return arr.astype(wdt).astype(arr.dtype)


class _CastCodec:
    """Ship chunks cast to a narrower float dtype (bfloat16: half the
    fp32 wire bytes, ~2^-8 relative rounding per cast event); received
    frames cast back up into the accumulation dtype."""

    max_scale = 0.0              # cast codecs don't report a quant bound

    def __init__(self, wdt):
        self.wdt = wdt
        self.tag = wdt.str

    def encode(self, arr: np.ndarray) -> bytes:
        if self.wdt is BFLOAT16:
            return bf16_bits(arr).tobytes()
        return arr.astype(self.wdt, copy=False).tobytes()

    def decode(self, frame, n: int, wire: np.dtype) -> np.ndarray:
        if self.wdt is BFLOAT16:
            return bf16_values(np.frombuffer(frame, np.uint16, n)) \
                .astype(wire, copy=False)
        return np.frombuffer(frame, self.wdt, n).astype(wire)


def resolve_wire_dtype(wire_dtype):
    """Map the user-facing ``wire_dtype`` option to a wire dtype: None,
    ``BFLOAT16`` for "bfloat16" (or any dtype object of that name), or
    numpy's float16 for "float16"."""
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, str) and wire_dtype == "bfloat16" \
            or getattr(wire_dtype, "name", None) == "bfloat16":
        return BFLOAT16
    try:
        dt = np.dtype(wire_dtype)
    except TypeError:
        dt = None
    if dt == np.float16:
        return dt
    raise ValueError(
        f"wire_dtype must be None, 'bfloat16' or 'float16', "
        f"got {wire_dtype!r}")


def _make_codec(quantize: Optional[str], wdt: Optional[np.dtype]):
    if quantize == "int8":
        return _Int8Codec()
    if quantize == "int4":
        return _Int4Codec()
    if wdt is not None:
        return _CastCodec(wdt)
    return None


def codec_roundtrip(x: np.ndarray, quantize: str) -> np.ndarray:
    """What a lossy wire codec would RECONSTRUCT from ``x`` — the local
    encode/decode round-trip error-feedback accumulation subtracts to
    recover the residual the wire dropped, without any extra frames
    (train/collective.py ErrorFeedback). Block boundaries here follow
    the flat vector; the ring chunks by channel slot, so per-element
    scales can differ slightly — EF only needs the residual to be a
    faithful estimate, not bitwise wire parity.

    Computed straight from the block scales, without building frames:
    bitwise ``decode(encode(x))`` of the int8 and int4 codecs (the same
    scales, the same rounding, the same product), in half the time of a
    round-trip through the frames."""
    codec = _make_codec(quantize, None)
    if codec is None:
        return np.asarray(x, np.float32)
    flat = np.ascontiguousarray(np.asarray(x, np.float32)).reshape(-1)
    levels = 127.0 if quantize == "int8" else 7.0
    n = flat.size
    nb = -(-n // QUANT_BLOCK)
    xb = flat
    if n % QUANT_BLOCK:
        xb = np.zeros(nb * QUANT_BLOCK, np.float32)
        xb[:n] = flat
    xb = xb.reshape(nb, QUANT_BLOCK)
    absmax = xb.__abs__().max(axis=1)
    finite = np.isfinite(absmax)
    div = np.where(finite & (absmax > 0.0), absmax / levels,
                   np.float32(1.0)).astype(np.float32)
    t = xb / div[:, None] if finite.all() else \
        np.where(finite[:, None], xb, np.float32(0.0)) / div[:, None]
    np.rint(t, out=t)
    scales = np.where(finite,
                      np.where(absmax > 0.0, absmax / levels,
                               np.float32(0.0)),
                      np.float32(np.nan)).astype(np.float32)
    # the codecs ship q as int8 (int4: a nibble holding the same value)
    out = t.astype(np.int8).astype(np.float32)
    out *= scales[:, None]
    return out.reshape(-1)[:n]


# Last observed per-codec error bound in THIS process (what _finish
# just pushed to the tagged gauge) — the live signal
# ``allreduce_gradients(codec="auto")`` consults to back off a codec
# whose bound tripped. Keyed by codec tag ("int8"/"int4"/"bf16"/...).
_LAST_QUANT_ERR: Dict[str, float] = {}


def last_quant_error(tag: str) -> Optional[float]:
    """The most recent ``allreduce_quant_error`` this process observed
    for one codec tag, or None when that codec never ran here."""
    return _LAST_QUANT_ERR.get(tag)


def _codec_gauge_tag(q: Optional[str], codec) -> str:
    """The {codec=...} label value for one round: the quantize mode
    when set, the cast codec's short name, "fp32" otherwise."""
    if q:
        return q
    wdt = getattr(codec, "wdt", None)
    if wdt is not None:
        return "bf16" if "bfloat16" in str(wdt) else "fp16"
    return "fp32"


def rebuild_from_layout(flat: np.ndarray, layout: dict):
    """Reassemble a flat vector into the pytree a reduce-scatter-style
    layout describes: {"rebuild": closure, "leaves": [(shape, size,
    out_dtype)]}. THE single flat->pytree path — ring.allgather, the
    train world_size==1 twin, and ShardedOptimizer all rebuild through
    here so the cast-back policy cannot drift between them."""
    outs, off = [], 0
    for shape, size, dt in layout["leaves"]:
        outs.append(flat[off:off + size].reshape(shape)
                    .astype(dt, copy=False))
        off += size
    return layout["rebuild"](iter(outs))


# --- torch leaves on the host plane --------------------------------------
#
# The ring reduces numpy. A torch tensor (on any device) crosses it as a
# numpy array of its values — floats narrower than 32 bits are cast to
# float32 ON THEIR DEVICE first (numpy has no bfloat16; float32 is the
# wire dtype _wire_dtype picks for their mean anyway) — and the result
# comes back as a tensor of the input leaf's dtype on its device. The
# module never imports torch: without it in the process, no value can
# hold a tensor.


def _tensor_type():
    torch = sys.modules.get("torch")
    return None if torch is None else torch.Tensor


def stage_leaf(leaf) -> np.ndarray:
    """One leaf as a host numpy array (a device->host copy for a CUDA
    tensor; a view of a CPU tensor's memory when no cast is needed)."""
    t_type = _tensor_type()
    if t_type is not None and isinstance(leaf, t_type):
        t = leaf.detach()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _map_leaves(value, fn):
    """``value`` with every leaf replaced by ``fn(leaf)``, in
    ``_flatten``'s structure rules."""
    if isinstance(value, dict):
        t = type(value)
        out = {k: _map_leaves(v, fn) for k, v in value.items()}
        return out if t is dict else t(out)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_map_leaves(x, fn) for x in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_map_leaves(x, fn) for x in value)
    return fn(value)


def _zip_leaves(value, like, fn):
    """``value`` rebuilt with ``fn(leaf, like_leaf)`` per leaf, walking
    ``like`` (the same structure) alongside."""
    if isinstance(like, dict):
        t = type(value)
        out = {k: _zip_leaves(value[k], like[k], fn) for k in like}
        return out if t is dict else t(out)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(value)(*(_zip_leaves(v, lk, fn)
                             for v, lk in zip(value, like)))
    if isinstance(like, (list, tuple)):
        return type(value)(_zip_leaves(v, lk, fn)
                           for v, lk in zip(value, like))
    return fn(value, like)


def to_host(value):
    """``(host_value, like)``: the pytree with every torch leaf staged to
    numpy (``stage_leaf``), and the original pytree to restore tensors
    from (``from_host``) — None when no leaf was a tensor, so a numpy
    pytree passes through untouched."""
    t_type = _tensor_type()
    if t_type is None:
        return value, None
    found = []

    def leaf(v):
        if isinstance(v, t_type):
            found.append(True)
            return stage_leaf(v)
        return v
    host = _map_leaves(value, leaf)
    return (host, value) if found else (value, None)


def tensor_like(arr, like):
    """A host result as a tensor of ``like``'s dtype on ``like``'s device
    (floating results are cast on the device after the copy; integer
    results keep the dtype the reduce gave them — an integer mean stays
    float64, as the star's does)."""
    import torch
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    if like.is_floating_point() and t.is_floating_point():
        t = t.to(like.dtype)
    return t


def from_host(result, like):
    """Undo ``to_host`` on a reduced result: each leaf whose input was a
    torch tensor comes back as one (``tensor_like``); every other leaf
    as the ring returned it."""
    if like is None:
        return result
    t_type = _tensor_type()
    return _zip_leaves(
        result, like,
        lambda r, lk: tensor_like(r, lk) if isinstance(lk, t_type) else r)


def _numel(leaf) -> int:
    return leaf.numel() if hasattr(leaf, "numel") else int(np.size(leaf))


def stage_flat(value):
    """``(flat, like)``: when every leaf of ``value`` is a floating torch
    tensor of at most 32 bits, their values in ``_flatten``'s order in
    ONE host float32 vector, each leaf cast on its device and copied
    straight into its slice (the vector the ring would otherwise build
    from staged leaves, without that second host copy), and ``value``
    to rebuild from (``unflat``); ``(None, None)`` for any other
    pytree."""
    t_type = _tensor_type()
    if t_type is None:
        return None, None
    leaves: list = []
    _map_leaves(value, leaves.append)
    if not leaves or not all(isinstance(l, t_type)
                             and l.is_floating_point()
                             and l.element_size() <= 4 for l in leaves):
        return None, None
    import torch
    flat = np.empty(sum(l.numel() for l in leaves), np.float32)
    host = torch.from_numpy(flat)
    off = 0
    for l in leaves:
        n = l.numel()
        host[off:off + n].copy_(l.detach().reshape(-1))
        off += n
    return flat, value


def unflat(flat: np.ndarray, like):
    """``like``'s pytree rebuilt from a flat host vector in ``_flatten``'s
    order: each tensor leaf of ``like`` back as a tensor of its dtype on
    its device (``tensor_like``)."""
    leaves: list = []
    _map_leaves(like, leaves.append)
    outs, off = [], 0
    for l in leaves:
        n = _numel(l)
        outs.append(tensor_like(flat[off:off + n].reshape(tuple(l.shape)),
                                l))
        off += n
    it = iter(outs)
    return _map_leaves(like, lambda _: next(it))


# --- collective tracing + flight recorder --------------------------------


TRACE_LEVELS = ("off", "round", "chunk")


class _RingTrace:
    """Per-participant collective tracing and flight recorder.

    Levels (Config.collective_trace_level, overridable per ring spec):

      "round"  one structured span per collective round — collective
               id, op, payload bytes, codec, send/recv-wait/header
               timing — recorded into the bounded "collective" event
               category (util/events) so it rides the existing
               worker -> agent -> head collection into
               ``timeline(all_nodes=True)`` / ``to_chrome`` as
               per-rank ring lanes with cross-rank flow edges.
      "chunk"  additionally one span per chunk send / recv-wait /
               reduce-decode, tagged with phase, segment and round —
               the depth that localizes a slow link to a specific
               pipeline position.

    **Straggler attribution** costs zero extra frames: each rank
    piggybacks its previous round's recv-wait total on the header
    relay (headers already reach every rank), so during round k+1
    every rank holds every rank's round-k wait and computes the SAME
    straggler — the rank *preceding* the argmax waiter, because a slow
    rank starves its downstream neighbor's reads. Exported as the
    head-aggregated ``allreduce_straggler_rank`` gauge plus per-rank
    ``collective_recv_wait_s`` histograms.

    The **flight recorder** keeps the last K rounds' timing records in
    a bounded deque regardless of event-buffer pressure; when a round
    dies (peer death, agreed ERROR frame, protocol desync) ``dump()``
    writes them to a JSON file and ``attach()`` stitches the path into
    the raised exception's message and ``flight_recorder_path``
    attribute — the first hang in a 600 s-timeout job stays
    diagnosable after the process is gone.
    """

    _KIND = {"round": "allreduce", "rs_round": "reduce_scatter",
             "ag_round": "allgather", "bc_round": "broadcast"}

    def __init__(self, rank: int, size: int, level: str, group: str,
                 metrics: dict, flight_rounds: int, flight_dir: str,
                 ring_level: Optional[str] = None):
        self.rank, self.size = int(rank), int(size)
        self.level = level
        # hierarchy level tag stamped on every span this sub-ring
        # records ("intra"/"inter"; broadcast rounds override to
        # "bcast"); None for a flat ring. Keeps to_chrome lanes and
        # straggler attribution from cross-wiring the two levels —
        # each sub-ring also carries a distinct group id.
        self.ring_level = ring_level
        self.group = group or "ring"
        self._m = metrics
        self.flight: "deque" = deque(maxlen=max(1, int(flight_rounds or 1)))
        self.flight_dir = flight_dir
        self.round_no = -1
        self.step: Optional[int] = None   # train-step tag (callers set)
        self.prev_wait: Optional[float] = None
        self.last_rw: Dict[int, float] = {}
        self.last_straggler: Optional[int] = None
        self.last_dump_path: Optional[str] = None
        self._last_dump_ts = 0.0
        self.cur: Optional[dict] = None

    # -- round lifecycle --------------------------------------------------

    def begin(self) -> None:
        self.round_no += 1
        self.cur = {"round": self.round_no, "t0": time.time(),
                    "kind": None, "op": None, "codec": None,
                    "level": self.ring_level,
                    "step": self.step, "send_s": 0.0, "wait_s": 0.0,
                    "apply_s": 0.0, "hdr_s": 0.0}
        if self.level == "chunk":
            self.cur["chunks"] = []

    def options(self, op: str, codec: Optional[str]) -> None:
        if self.cur is not None:
            self.cur["op"] = op
            self.cur["codec"] = codec

    def io(self, what: str, dt: float, nbytes: int, phase: str,
           seg: int, apply_s: float = 0.0) -> None:
        """One wire operation: ``what`` is "send" or "recv", ``dt`` the
        blocked time, ``apply_s`` the in-window decode/reduce time of a
        read_with callback.

        ``wait_s`` — the straggler-attribution signal — counts the
        FIRST header read (the direct wait for the predecessor to
        enter the round) plus every data-phase read. Later header
        reads are RELAY forwards: a late entrant's delay reaches every
        rank through them with nearly equal magnitude, which would
        smear the argmax across innocent ranks — those land in
        ``hdr_s`` instead."""
        cur = self.cur
        if cur is None:
            return
        if phase == "hdr":
            if what == "recv" and not cur.get("_hdr0"):
                cur["_hdr0"] = True
                cur["wait_s"] += dt
            else:
                cur["hdr_s"] += dt + apply_s
        elif what == "send":
            cur["send_s"] += dt
        else:
            cur["wait_s"] += dt
            cur["apply_s"] += apply_s
        if "chunks" in cur and phase != "hdr":
            cur["chunks"].append(
                {"name": what, "ts": time.time() - dt - apply_s,
                 "dur": dt, "apply_s": round(apply_s, 6),
                 "phase": phase, "seg": seg, "bytes": nbytes})

    def header_extra(self) -> dict:
        ex: dict = {"rn": self.round_no}
        if self.prev_wait is not None:
            ex["rw"] = self.prev_wait
        return ex

    def on_headers(self, headers: Dict[int, dict]) -> None:
        rw = {o: float(h["rw"]) for o, h in headers.items()
              if h.get("rw") is not None}
        if len(rw) != self.size:
            return                     # first round: no prior data yet
        self.last_rw = rw
        waits = sorted(rw.values())
        top = max(rw, key=lambda o: rw[o])
        # significance gate: only attribute when one rank's wait
        # DOMINATES (>= 5 ms absolute and >= 2x the median of the
        # OTHER ranks' waits — overall median would equal the max for
        # N=2 and block attribution there) — a healthy round's argmax
        # is scheduler noise, and pinning a gauge to an innocent rank
        # is worse than saying "none"
        rest = waits[:-1]
        med = rest[len(rest) // 2]
        if rw[top] >= 0.005 and rw[top] >= 2.0 * med:
            # everyone's reads stalled behind the rank BEFORE the
            # longest waiter: that predecessor is the straggler
            self.last_straggler = (top - 1) % self.size
        else:
            self.last_straggler = None
        try:
            self._m["straggler"].set(
                -1 if self.last_straggler is None
                else self.last_straggler)
        except Exception:
            pass

    def end(self, key: str, wrote: int,
            err: Optional[BaseException]) -> None:
        cur, self.cur = self.cur, None
        if cur is None:
            return
        kind = self._KIND.get(key, key)
        cur.pop("_hdr0", None)
        dur = time.time() - cur["t0"]
        cur.update(kind=kind, dur=round(dur, 6), bytes=int(wrote),
                   error=repr(err) if err is not None else None)
        self.prev_wait = cur["wait_s"]
        chunks = cur.pop("chunks", None)
        self.flight.append(dict(cur, chunks=chunks) if chunks is not None
                           else cur)
        try:
            self._m["recv_wait"].observe(
                cur["wait_s"], tags={"rank": str(self.rank)})
        except Exception:
            pass
        try:
            # the round's recv wait is by construction NOT hidden under
            # compute (the caller is blocked in the collective) — it is
            # the goodput ledger's comm_exposed category, attributed to
            # whatever step window is open on this thread
            from ray_tpu_torch.util import goodput
            goodput.add("comm_exposed", cur["wait_s"])
        except Exception:
            pass
        events.record(
            "collective", "round", ph="X", ts=cur["t0"], dur=dur,
            kind=kind, op=cur["op"], codec=cur["codec"],
            level=cur.get("level"),
            group=self.group, cid=cur["round"], rank=self.rank,
            size=self.size, step=cur["step"], bytes=cur["bytes"],
            send_s=round(cur["send_s"], 6),
            recv_wait_s=round(cur["wait_s"], 6),
            headers_s=round(cur["hdr_s"], 6),
            straggler=self.last_straggler,
            error=err is not None, pid=os.getpid())
        for c in chunks or ():
            events.record(
                "collective", c["name"], ph="X", ts=c["ts"],
                dur=c["dur"] + c["apply_s"], phase=c["phase"],
                seg=c["seg"], bytes=c["bytes"], group=self.group,
                cid=cur["round"], rank=self.rank, pid=os.getpid())
        if err is not None:
            self.attach(err, self.dump(err))

    # -- post-mortem ------------------------------------------------------

    def summary(self) -> dict:
        last = None
        for r in reversed(self.flight):
            last = {k: v for k, v in r.items() if k != "chunks"}
            break
        return {"rank": self.rank, "size": self.size,
                "group": self.group,
                # set by RingReducer.from_spec (channel.spec_transport):
                # a post-mortem reader learns whether the hung edge was
                # a TCP link or same-host shm without the spec in hand
                "transports": getattr(self, "transports", None),
                "rounds_recorded": len(self.flight),
                "last_straggler": self.last_straggler,
                "recv_wait_by_rank": dict(self.last_rw),
                "last_round": last}

    def dump(self, err: Optional[BaseException]) -> Optional[str]:
        """Write the flight records to a JSON file; returns the path.
        Rate-limited (a dag loop relaying ERROR frames per item must
        not write one file per item); never raises — post-mortem
        bookkeeping must not mask the real failure."""
        now = time.time()
        if now - self._last_dump_ts < 5.0:
            return self.last_dump_path
        try:
            d = self.flight_dir or os.path.join(
                tempfile.gettempdir(), "ray_tpu_torch_flight")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"ring-{self.group}-r{self.rank}-{os.getpid()}-"
                   f"{int(now * 1000)}.json")
            rounds = list(self.flight)
            if self.cur is not None:       # the in-flight failing round
                rounds.append(dict(self.cur))
            with open(path, "w") as f:
                json.dump({"error": repr(err) if err else None,
                           "ts": now, **self.summary(),
                           "rounds": rounds}, f, default=str)
            self._last_dump_ts = now
            self.last_dump_path = path
            return path
        except Exception:
            return None

    def attach(self, err: Optional[BaseException],
               path: Optional[str]) -> None:
        """Stitch the dump path + a per-rank summary into the raised
        exception (and its RingPeerDead ``cause``, whose message is
        what train/dag error paths re-surface). The message is only
        rewritten for rank-LOCAL terminal errors (peer death, protocol
        desync — the path is per-rank anyway); agreed error frames
        must stay byte-identical on every rank, so those carry the
        path as attributes only."""
        if err is None or path is None:
            return
        note = f" [collective flight recorder: {path}]"
        local = isinstance(err, (RingPeerDead, RingProtocolError))
        for e in (err, getattr(err, "cause", None)):
            if not isinstance(e, BaseException):
                continue
            try:
                e.flight_recorder_path = path
                e.flight_recorder_summary = self.summary()
                if local and e.args and isinstance(e.args[0], str) \
                        and path not in e.args[0]:
                    e.args = (e.args[0] + note,) + e.args[1:]
            except Exception:
                pass


# --- the ring ------------------------------------------------------------


class RingReducer:
    """One participant's endpoint pair in a ring allreduce group. Every
    participant must enter every round (with a value, or with the ERROR
    frame it would have shipped) and all per-round options (op,
    quantize) must match across the group — mismatches are detected in
    the header phase and surface as the same error on every rank."""

    def __init__(self, to_next, from_prev, *, rank: int, size: int,
                 op: str = "sum", timeout_s: float = 600.0,
                 quantize: Optional[str] = None,
                 chunk_bytes: Optional[int] = None,
                 wire_dtype=None, own: Optional[int] = None,
                 trace_level: Optional[str] = None, group: str = "",
                 level: Optional[str] = None, tune: bool = False):
        if size < 2:
            raise ValueError("ring allreduce needs at least 2 ranks")
        if quantize not in _QUANTIZE_MODES:
            raise ValueError(f"quantize must be one of {_QUANTIZE_MODES}")
        self.to_next = to_next
        self.from_prev = from_prev
        self.rank = int(rank)
        self.size = int(size)
        self.op = op
        self.timeout_s = float(timeout_s)
        self.quantize = quantize
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        # The flat value space is split into `size` contiguous segments
        # (total*i//n .. total*(i+1)//n); this rank OWNS segment `own`
        # after a reduce-scatter — the shard the ZeRO optimizer updates.
        # Ring consistency requires ownership to be a rotation:
        # own(r) = (r + shift) % n with the SAME shift on every rank —
        # validated in the header phase via the shift tag.
        self.own = self.rank if own is None else int(own)
        if not 0 <= self.own < self.size:
            raise ValueError(
                f"own segment {self.own} out of range for {size} ranks")
        slot = min(to_next.slot_bytes, from_prev.slot_bytes)
        # floor at 4096 (tiny chunks drown in per-frame overhead) but
        # NEVER exceed the slot — a chunk that can't fit its channel
        # would desync the group mid-phase
        self.chunk_bytes = min(slot, max(
            4096, min(chunk_bytes or DEFAULT_CHUNK_BYTES, slot)))
        self._m = allreduce_metrics()
        self._wrote = 0           # wire bytes this round (batched inc)
        self._layout = None       # cached by reduce_scatter for allgather
        # Group label: tags spans/flight dumps, and keys the in-situ
        # tuner cache (one profile per ring generation).
        self.group = group or ""
        # Hierarchy level of THIS ring ("intra"/"inter" for the
        # sub-rings of a HierarchicalReducer, None for a flat ring):
        # stamped on every span, and "inter" rings additionally meter
        # their writes into allreduce_hier_inter_bytes_total.
        self.level = level
        if level not in (None, "intra", "inter"):
            raise ValueError(
                f"ring level must be None, 'intra' or 'inter', "
                f"got {level!r}")
        # In-situ auto-tuning (dag/tuner.py): when set, the first
        # collective op runs two tiny probe rounds (identically on
        # every rank — probes ARE collectives) and later rounds pick
        # their chunk size from the tuned table per payload band.
        self._tune = bool(tune)
        self._tuning = False      # reentrancy guard: probes call reduce
        self._base_chunk = self.chunk_bytes
        self._payload_hint: Optional[int] = None  # last round's bytes
        # Collective tracing + flight recorder (Config default, spec
        # override). "off" skips every clock read on the hot path.
        from ray_tpu_torch.config import get_config
        cfg = get_config()
        level = trace_level if trace_level is not None \
            else getattr(cfg, "collective_trace_level", "round")
        if level not in TRACE_LEVELS:
            raise ValueError(
                f"collective trace level must be one of {TRACE_LEVELS}, "
                f"got {level!r}")
        self._tr = None if level == "off" else _RingTrace(
            self.rank, self.size, level, group, self._m,
            getattr(cfg, "collective_flight_rounds", 8),
            getattr(cfg, "collective_flight_dir", ""),
            ring_level=self.level)
        self.step: Optional[int] = None   # train-step span tag
        self._tr_err: Optional[BaseException] = None
        self._ph = "hdr"                  # current phase for chunk spans
        self._seg_tx = self._seg_rx = -1  # current segments in flight
        self._abort = False               # set by abort() (any thread)
        # Hang/desync forensics: the process-wide collective ledger
        # this ring feeds (util/forensics.py). Resolved once here —
        # per round the cost is two dict appends when on, one None
        # check when off.
        self._fx = forensics.ledger() if forensics.enabled() else None
        self._fx_tok: Optional[int] = None

    @classmethod
    def from_spec(cls, spec: Dict[str, Any],
                  abort=None) -> "RingReducer":
        """Attach both ring edges from a controller-built spec:
        {"rank", "size", "to_next", "from_prev", "op"?, "timeout_s"?,
        "quantize"?, "chunk_bytes"?} — channel specs are the same dicts
        the dag compiler produces (shm / lazy-shm / tcp).

        The consumer side attaches FIRST: lazy shm segments are created
        by their consumer, so when every rank attaches concurrently each
        must create its inbound edge before polling for its outbound
        one — the reverse order deadlocks the whole ring at attach.
        Attach waits honor the spec's timeout_s (participants may reach
        their first round arbitrarily skewed — compile, data load), and
        an attach that still times out surfaces as RingPeerDead like
        any other unresponsive-neighbor condition. ``abort`` (polled
        by the blocking lazy-shm producer wait) interrupts an attach
        early — the elastic rewire path, where the specs belong to an
        incarnation the controller has already declared dead."""
        timeout_s = float(spec.get("timeout_s", 600.0))
        from_prev = None
        try:
            from_prev = attach_channel(spec["from_prev"], "consumer",
                                       timeout=timeout_s, abort=abort)
            to_next = attach_channel(spec["to_next"], "producer",
                                     timeout=timeout_s, abort=abort)
        except (ChannelTimeout, ChannelClosed) as e:
            if from_prev is not None:
                # we created the inbound (consumer-owned) segment;
                # don't leak it when the outbound attach fails
                try:
                    from_prev.close()
                    if getattr(from_prev, "_lazy_owner", False):
                        from_prev.unlink()
                except Exception:
                    pass
            raise RingPeerDead(RuntimeError(
                f"ring allreduce peer never attached within "
                f"{timeout_s}s (participant died before its first "
                f"round?): {e}"))
        ring = cls(to_next, from_prev,
                   rank=spec["rank"], size=spec["size"],
                   op=spec.get("op", "sum"),
                   timeout_s=timeout_s,
                   quantize=spec.get("quantize"),
                   chunk_bytes=spec.get("chunk_bytes"),
                   wire_dtype=spec.get("wire_dtype"),
                   own=spec.get("own"),
                   trace_level=spec.get("trace_level"),
                   group=spec.get("group", ""),
                   level=spec.get("level"),
                   tune=bool(spec.get("tune")))
        # transport mix for post-mortems: flight-dump summaries say
        # whether a slow/hung edge was a TCP link or same-host shm
        from ray_tpu_torch.dag.channel import spec_transport
        ring.transports = {"from_prev": spec_transport(spec["from_prev"]),
                           "to_next": spec_transport(spec["to_next"])}
        if ring._tr is not None:
            ring._tr.transports = ring.transports
        return ring

    def channels(self) -> list:
        return [self.to_next, self.from_prev]

    def close(self):
        for ch in self.channels():
            try:
                ch.close()
                if getattr(ch, "_lazy_owner", False):
                    ch.unlink()
            except Exception:  # noqa: BLE001 — teardown
                pass

    # --- wire helpers ---------------------------------------------------

    def abort(self) -> None:
        """Interrupt any blocked ring op from ANOTHER thread (the
        elastic-training rewire path: the controller has already
        decided this incarnation is dead, so a survivor blocked on a
        dead neighbor must not wait out the full ring timeout before
        it can re-form). The next sliced wait raises RingPeerDead with
        a reshape message; the flag is sticky for this ring — a
        reshaped group attaches a FRESH ring. Any in-flight ledger
        entry is stamped terminal ``aborted`` HERE (not just when the
        blocked op unwinds) so a post-abort audit never reports a
        phantom in-flight collective from a rank that already gave
        up."""
        self._abort = True
        try:
            if self._fx is not None and self._fx_tok is not None:
                self._fx.exit(self._fx_tok, state="aborted",
                              err="abort(): ring declared dead while "
                                  "the collective was in flight")
        except Exception:   # noqa: BLE001 — bookkeeping must not mask
            pass

    def _op_sliced(self, op):
        """Run one channel op under the ring timeout, sliced into
        short waits (_ABORT_SLICE_S) so abort() can interrupt a
        blocked participant. ``op(t)`` must be safely retryable after
        a ChannelTimeout with no partial effect — both channel flavors
        guarantee that (shm waits are stateless; TcpChannel reads
        resume mid-frame and its writes only time out before any frame
        byte is committed). ChannelAttachRefused is retried too: a
        refused connect within one slice means the peer may still be
        mid-restart, and only the ring timeout decides it is dead."""
        if self._abort:
            raise _AbortedOp()
        deadline = time.monotonic() + self.timeout_s
        retrying = False
        try:
            while True:
                left = deadline - time.monotonic()
                try:
                    return op(max(1e-3, min(_ABORT_SLICE_S, left)))
                except (ChannelTimeout, ChannelAttachRefused) as e:
                    if self._abort:
                        raise _AbortedOp()
                    # an injected chaos read-drop fires exactly once —
                    # a retry would re-read the still-present frame and
                    # silently nullify the fault, so surface it as-is
                    if getattr(e, "chaos_injected", False) \
                            or time.monotonic() >= deadline:
                        raise
                    # retries re-enter the same LOGICAL channel op:
                    # keep the chaos Nth-op counters from advancing
                    retrying = True
                    chaos_mark_retry(True)
        finally:
            if retrying:
                chaos_mark_retry(False)

    def _op_fail(self, which: str, e: BaseException) -> RingPeerDead:
        if isinstance(e, _AbortedOp):
            return RingPeerDead(RuntimeError(
                f"ring collective aborted on rank {self.rank}: the "
                f"worker group is being reshaped (elastic recovery)"))
        peer = (self.rank + 1) % self.size if which == "next" \
            else (self.rank - 1) % self.size
        return RingPeerDead(RuntimeError(
            f"ring allreduce peer (rank {peer})"
            f" unresponsive for {self.timeout_s}s "
            f"(participant died?): {e}"))

    def _write(self, payload):
        mv = payload if isinstance(payload, memoryview) \
            else memoryview(payload)
        tr = self._tr
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            self._op_sliced(
                lambda t: self.to_next.write(mv, DATA, timeout=t))
        except (ChannelTimeout, ChannelClosed, _AbortedOp) as e:
            if tr is not None:   # the stalled write IS the evidence
                tr.io("send", time.monotonic() - t0, mv.nbytes,
                      self._ph, self._seg_tx)
            raise self._op_fail("next", e)
        if tr is not None:
            tr.io("send", time.monotonic() - t0, mv.nbytes,
                  self._ph, self._seg_tx)
        self._wrote += mv.nbytes

    def _read_with(self, fn):
        tr = self._tr
        if tr is None:
            try:
                return self._op_sliced(
                    lambda t: self.from_prev.read_with(fn, t))
            except (ChannelTimeout, ChannelClosed, _AbortedOp) as e:
                raise self._op_fail("prev", e)
        # split the window into WAIT (blocked on the predecessor — the
        # straggler-attribution signal) and APPLY (fn: decode + reduce)
        t0 = time.monotonic()
        box = [t0, t0, 0]

        def timed(kind, mv, fn=fn):
            box[0] = time.monotonic()
            box[2] = mv.nbytes
            out = fn(kind, mv)
            box[1] = time.monotonic()
            return out

        try:
            out = self._op_sliced(
                lambda t: self.from_prev.read_with(timed, t))
        except (ChannelTimeout, ChannelClosed, _AbortedOp) as e:
            # record the fatal wait: in the flight dump THIS is the
            # row that shows where the round hung
            tr.io("recv", time.monotonic() - t0, 0,
                  self._ph, self._seg_rx)
            raise self._op_fail("prev", e)
        tr.io("recv", box[0] - t0, box[2], self._ph, self._seg_rx,
              apply_s=box[1] - box[0])
        return out

    def _read_bytes(self):
        return self._read_with(lambda k, mv: (k, bytes(mv)))

    # --- phases ---------------------------------------------------------

    def _exchange_headers(self, hdr: dict) -> Dict[int, dict]:
        """N-1 relay steps: send own header, forward what arrives.
        Every rank ends holding every rank's header — the ordered,
        deadlock-free carrier for errors and layout validation. The
        tracer piggybacks its previous-round recv-wait here (straggler
        attribution rides frames that move anyway)."""
        if self._tr is not None:
            hdr.update(self._tr.header_extra())
        if self._fx is not None and self._fx_tok is not None and \
                hdr.get("sig") is not None:
            # the ONE chokepoint every op's resolved options pass
            # through: the signature hash lands on the ledger row so a
            # cross-rank audit can diff what each rank actually sent
            self._fx.note(self._fx_tok,
                          sig=forensics.sig_hash(hdr["sig"]))
        self._ph = "hdr"
        headers = {self.rank: hdr}
        frame = dumps_oob(hdr)
        for _ in range(self.size - 1):
            self._write(frame)
            kind, data = self._read_bytes()
            if kind != DATA:
                raise RingProtocolError(
                    f"unexpected frame kind {kind} in ring header phase")
            got = loads_oob(data)
            headers[got["origin"]] = got
            frame = data
        if self._tr is not None:
            self._tr.on_headers(headers)
        return headers

    def _chunks(self, lo: int, hi: int, itemsize: int):
        step = max(1, self.chunk_bytes // itemsize)
        return [(p, min(p + step, hi)) for p in range(lo, hi, step)]

    def _send_chunk(self, arr: np.ndarray):
        if self._codec is not None:
            self._write(self._codec.encode(arr))
        else:
            self._write(arr.data.cast("B"))

    def _begin(self, op: Optional[str], quantize, wire_dtype,
               kind: str = "allreduce"):
        """Resolve + validate per-round options BEFORE any frame moves
        (a bad option discovered mid-phase would waste a collective
        round on every rank). Returns the resolved op; sets the round's
        codec. The shift tag ((own - rank) % size) rides every header
        sig: segment ownership must be the same rotation on all ranks
        or reduce-scatter results would interleave garbage.

        Safe defaults land FIRST so _finish (in the caller's finally)
        works even when validation raises — the standalone ops call
        this inside their error-frame try, turning a rank-local option
        failure (e.g. one host missing ml_dtypes) into an error frame
        every peer sees in one relay instead of a ring-timeout stall."""
        self._q = None
        self._codec = None
        self._shift = (self.own - self.rank) % self.size
        self._qmax = 0.0
        self._wrote = 0
        self._tr_err = None
        self._fx_tok = None   # cleared FIRST: a validation raise below
        #                       must not leave _finish a stale token
        self._ph = "hdr"
        self._seg_tx = self._seg_rx = -1
        if self._tr is not None:
            self._tr.step = self.step
            self._tr.begin()
        op = op or self.op
        if op not in ("sum", "mean", "max", "min"):
            raise ValueError(f"unknown op {op!r}")
        q = self.quantize if quantize is _UNSET else quantize
        if q not in _QUANTIZE_MODES:
            raise ValueError(f"quantize must be one of {_QUANTIZE_MODES}")
        wdt = self.wire_dtype if wire_dtype is _UNSET \
            else resolve_wire_dtype(wire_dtype)
        if q is not None and wdt is not None:
            raise ValueError(
                "quantize and wire_dtype are both wire codecs — pass "
                "at most one")
        self._q = q
        self._codec = _make_codec(q, wdt)
        if self._tr is not None:
            self._tr.options(op, self._codec.tag if self._codec else None)
        if self._fx is not None:
            # ledger enter AFTER option validation: a raise above never
            # reaches the wire, so it must not leave an in_flight row
            g = self.group or "ring"
            self._fx_tok = self._fx.enter(
                group=g, kind=kind, seq=self._fx.next_seq(g), op=op,
                codec=self._codec.tag if self._codec else None,
                step=self.step, size=self.size)
        return op

    def _finish(self, key: str, t0: float):
        if self._codec is not None:
            self._qmax = max(self._qmax, self._codec.max_scale)
        self._m["bytes"].inc(self._wrote)
        if self.level == "inter":
            # the cross-node leg of a hierarchical collective: THE
            # traffic the ring-of-rings exists to shrink
            self._m["hier_inter_bytes"].inc(self._wrote)
        tag = _codec_gauge_tag(self._q, self._codec)
        err = 0.5 * self._qmax * self.size if self._q else 0.0
        self._m["quant_err"].set(err, tags={"codec": tag})
        _LAST_QUANT_ERR[tag] = err
        self._m[key].observe(time.monotonic() - t0)
        if self._tr is not None:
            try:            # tracing must never mask the round's error
                self._tr.end(key, self._wrote, self._tr_err)
            except Exception:
                pass
        if self._fx is not None and self._fx_tok is not None:
            try:            # ledger close rides the same clock read
                self._fx.exit(
                    self._fx_tok,
                    state="done" if self._tr_err is None else "aborted",
                    err=None if self._tr_err is None
                    else f"{type(self._tr_err).__name__}: "
                         f"{self._tr_err}",
                    nbytes=self._wrote)
            except Exception:
                pass
            self._fx_tok = None

    # --- in-situ auto-tuning (dag/tuner.py) ------------------------------

    def _ensure_tuned(self):
        """Lazily run the one-shot in-situ micro-bench on THIS ring
        the first time any collective op is called (probes are
        themselves collective rounds, so every rank reaches them in
        lockstep and runs the identical sequence). Cached per ring
        generation — keyed by the group id, which the controller
        regenerates per incarnation — so a rewired group re-probes.
        No-op unless the spec opted in (``tune``) and
        Config.collective_tuner is on."""
        if not self._tune or self._tuning:
            return
        from ray_tpu_torch.config import get_config
        if not getattr(get_config(), "collective_tuner", True):
            return
        from ray_tpu_torch.dag import tuner
        if tuner.profile_for(self.group, self.size) is not None:
            return
        self._tuning = True
        try:
            tuner.probe_ring(self)
        finally:
            self._tuning = False

    def _apply_tuned_chunk(self, payload_bytes: int) -> None:
        """Per-round chunk size from the tuned table's payload band
        (falls back to the constructor chunk when untuned), plus the
        ``collective_tuner_regime`` gauge for this payload. The
        payload hint is derived from the ALREADY-flattened layout —
        never a flatten-just-to-size pass — and memoized in
        ``_payload_hint``: training steps repeat the same layout, so
        every round after the first reuses the previous decision
        instead of re-consulting the tuner table."""
        payload_bytes = int(payload_bytes)
        if not self._tune or self._tuning:
            if not self._tuning:     # probe rounds must not poison
                self._payload_hint = payload_bytes   # the memo
            return
        if payload_bytes == self._payload_hint:
            return                   # same layout as last round
        self._payload_hint = payload_bytes
        from ray_tpu_torch.dag import tuner
        slot = min(self.to_next.slot_bytes, self.from_prev.slot_bytes)
        c = tuner.tuned_chunk(self.group, self.size, payload_bytes, slot)
        self.chunk_bytes = c if c else self._base_chunk
        tuner.choose_impl(payload_bytes, self.size,
                          hierarchical=self.level == "inter",
                          key=self.group)   # records the regime gauge

    def _check_codec_wire(self, wire: np.dtype):
        if self._codec is not None and wire.kind != "f":
            name = (f"{self._q} block quantization" if self._q
                    else f"wire_dtype={self._codec.tag!r}")
            raise TypeError(
                f"{name} requires floating-point values "
                f"(wire dtype would be {wire})")

    def round(self, kind: int, value, err_frame: Optional[bytes], *,
              op: Optional[str] = None,
              quantize=_UNSET, wire_dtype=_UNSET) -> Tuple[int, Any]:
        """One collective round. Returns (DATA, reduced_value) or
        (ERROR, frame) — the frame is an already-encoded exception every
        participant agrees on. Raises RingPeerDead when a neighbor stops
        responding (terminal for the group). ``op``/``quantize``/
        ``wire_dtype`` override the constructor defaults for this round
        (all ranks must pass the same values — validated in the header
        phase)."""
        self._ensure_tuned()
        op = self._begin(op, quantize, wire_dtype)
        t0 = time.monotonic()
        leaves = rebuild = wires = None
        hdr: Dict[str, Any] = {"origin": self.rank}
        if kind != DATA and err_frame is None:
            err_frame = dumps_oob(RuntimeError(
                "ring participant entered an error round without a "
                "frame"))
        if err_frame is None:
            try:
                leaves, rebuild, sig = _flatten(value)
                # PER-LEAF wire dtypes (star-path parity: an int64
                # counter next to float32 grads must neither widen the
                # grads to float64 nor round-trip the counter through
                # a float)
                wires = [_wire_dtype([l.dtype], op) for l in leaves]
                for w in wires:
                    self._check_codec_wire(w)
                hdr["sig"] = (sig, tuple(w.str for w in wires), op,
                              self._codec.tag if self._codec else None,
                              self._shift)
            except BaseException as e:  # noqa: BLE001 — enters as error
                try:
                    err_frame = dumps_oob(e)
                except Exception:
                    err_frame = dumps_oob(RuntimeError(
                        f"{type(e).__name__}: {e}"))
        if err_frame is not None:
            hdr["err"] = bytes(err_frame)
        try:
            headers = self._exchange_headers(hdr)
            agreed = self._agree(headers, "allreduce")
            if agreed is not None:
                # the frame is returned, not raised (the dag loop
                # forwards it downstream), so _tr_err must be set by
                # hand for the round span to record error=True; dump
                # now while the round is still in flight — reduce()
                # and other raisers attach last_dump_path
                self._tr_err = RuntimeError(
                    "collective round resolved to an agreed ERROR "
                    "frame")
                if self._tr is not None:
                    self._tr.dump(self._tr_err)
                return ERROR, agreed
            out = self._data_phases(leaves, rebuild, wires, op)
            return DATA, out
        except BaseException as e:  # noqa: BLE001 — flight recorder
            self._tr_err = e
            raise
        finally:
            self._finish("round", t0)

    def _agree(self, headers: Dict[int, dict],
               what: str) -> Optional[bytes]:
        """Post-header agreement: returns the ERROR frame every rank
        deterministically settles on (lowest-origin error, or a layout
        mismatch), or None when the round is clean."""
        err_origins = sorted(o for o, h in headers.items()
                             if h.get("err") is not None)
        if err_origins:
            return headers[err_origins[0]]["err"]
        sigs = {o: h["sig"] for o, h in headers.items()}
        if len(set(sigs.values())) != 1:
            lines = "; ".join(
                f"rank {o}: {sigs[o]!r}" for o in sorted(sigs))
            return dumps_oob(RuntimeError(
                f"ring {what} value layouts differ across "
                f"participants — {lines}"))
        return None

    def reduce(self, value, *, op: Optional[str] = None,
               quantize=_UNSET, wire_dtype=_UNSET):
        """Convenience wrapper: reduced value, or raises the group's
        agreed error (the train gradient-sync entrypoint)."""
        kind, out = self.round(DATA, value, None, op=op,
                               quantize=quantize, wire_dtype=wire_dtype)
        if kind == ERROR:
            err = loads_oob(out)
            if not isinstance(err, BaseException):
                err = RuntimeError(str(err))
            if self._tr is not None:
                self._tr.attach(err, self._tr.last_dump_path)
            raise err
        return out

    @staticmethod
    def _raise(frame):
        err = loads_oob(frame)
        raise err if isinstance(err, BaseException) \
            else RuntimeError(str(err))

    # --- standalone collective ops (the ZeRO building blocks) -----------

    def seg_bounds(self, total: int, seg: Optional[int] = None) -> \
            Tuple[int, int]:
        """(lo, hi) of segment ``seg`` (default: this rank's OWNED
        segment) in a flat length-``total`` value space — the canonical
        contiguous N-way split every collective op here uses."""
        s = self.own if seg is None else seg
        n = self.size
        return total * s // n, total * (s + 1) // n

    def reduce_scatter(self, value, *, op: Optional[str] = None,
                       quantize=_UNSET):
        """Standalone reduce-scatter: one header relay (layout/option
        validation + error propagation, exactly like a fused round)
        then the N-1 pipelined chunk steps — and NO allgather. Returns
        this rank's owned flat shard of the elementwise reduction: a
        1-D array, ``seg_bounds(total)`` of the flattened value space,
        mean already divided.

        Unlike the fused allreduce (which reduces per-leaf wire-dtype
        groups), the whole pytree is flattened into ONE wire dtype
        (numpy promotion over the leaves, low-precision floats widened
        to float32) — the flat shard is the unit the ZeRO optimizer
        updates. The layout is cached so a following allgather() can
        reassemble the full pytree. Raises the group's agreed error on
        layout mismatch / participant failure, RingPeerDead on a dead
        neighbor."""
        self._ensure_tuned()
        t0 = time.monotonic()
        leaves = rebuild = wire = None
        hdr: Dict[str, Any] = {"origin": self.rank}
        err_frame = None
        try:
            # option resolution INSIDE the try: a rank-local failure
            # ships as an error frame and reaches every peer in one
            # header relay instead of stalling them to ring timeout
            op = self._begin(op, quantize, _UNSET,
                             kind="reduce_scatter")
            leaves, rebuild, sig = _flatten(value)
            wire = _wire_dtype([l.dtype for l in leaves], op) \
                if leaves else np.dtype(np.float32)
            self._check_codec_wire(wire)
            hdr["sig"] = ("rs", sig, wire.str, op,
                          self._codec.tag if self._codec else None,
                          self._shift)
        except BaseException as e:  # noqa: BLE001 — enters as error
            try:
                err_frame = dumps_oob(e)
            except Exception:
                err_frame = dumps_oob(RuntimeError(
                    f"{type(e).__name__}: {e}"))
        if err_frame is not None:
            hdr["err"] = bytes(err_frame)
        try:
            headers = self._exchange_headers(hdr)
            agreed = self._agree(headers, "reduce_scatter")
            if agreed is not None:
                self._raise(agreed)
            src, total = self._flat_src(leaves, wire)
            self._apply_tuned_chunk(total * wire.itemsize)
            buf = np.empty(total, wire)
            bounds = [self.seg_bounds(total, i) for i in range(self.size)]
            self._rs_phase(src, buf, bounds, wire, op)
            lo, hi = bounds[self.own]
            if op == "mean":
                buf[lo:hi] /= self.size
            self._layout = {
                "rebuild": rebuild, "total": total, "wire": wire,
                "leaves": [(l.shape, l.size,
                            wire if _keeps_wide(l.dtype, op)
                            else l.dtype) for l in leaves]}
            return buf[lo:hi].copy()
        except BaseException as e:  # noqa: BLE001 — flight recorder
            self._tr_err = e
            raise
        finally:
            self._finish("rs_round", t0)

    def allgather(self, shard, *, wire_dtype=_UNSET, total_hint=None,
                  rebuild: bool = True):
        """Standalone allgather: every rank contributes its owned flat
        shard; after the header relay (shard lengths + dtype/option
        validation) and N-1 verbatim-forwarded chunk steps, every rank
        holds the full flat vector — reassembled into the cached
        reduce_scatter pytree layout when one matches (leaves cast back
        to their input dtypes), else returned flat.

        ``wire_dtype="bfloat16"`` ships every frame cast to bfloat16 —
        half the fp32 wire bytes, one ~2^-8-relative rounding event per
        element (the owner round-trips its own shard through the cast so
        all ranks stay bitwise identical). That is the ZeRO parameter
        reassembly: updated shards out, full (optionally bf16-shipped)
        parameters back.

        The cached layout is matched by ``total_hint`` when given, else
        by owned-slice length — a coincidental length match on an
        unrelated allgather reuses the stale layout; pass
        ``rebuild=False`` to ignore the cache entirely (flat vector
        back, wire dtype taken from the shard itself — what a caller
        that reassembles its own pytree wants, e.g. ShardedOptimizer
        rebuilding with PARAMETER leaf dtypes, not gradient ones)."""
        self._ensure_tuned()
        t0 = time.monotonic()
        hdr: Dict[str, Any] = {"origin": self.rank}
        err_frame = None
        layout = wire = None
        try:
            # everything that can fail on THIS rank's inputs — option
            # resolution included — happens inside the try: the failure
            # ships as an error frame and reaches every peer in one
            # header relay, instead of leaving them blocked for the
            # full ring timeout
            self._begin(None, _UNSET, wire_dtype, kind="allgather")
            shard = np.ascontiguousarray(np.asarray(shard)).reshape(-1)
            layout = self._layout if rebuild else None
            if layout is not None:
                # use the cached reduce_scatter layout only when this
                # shard plausibly IS that round's owned slice (explicit
                # total_hint, or matching owned-segment length) — a
                # stale layout must not silently recast an unrelated
                # allgather's wire dtype
                lo, hi = self.seg_bounds(layout["total"])
                if (layout["total"] != total_hint
                        if total_hint is not None
                        else hi - lo != shard.size):
                    layout = None
            wire = layout["wire"] if layout is not None else shard.dtype
            shard = np.ascontiguousarray(shard, dtype=wire)
            self._check_codec_wire(wire)
            hdr["n"] = shard.size
            hdr["sig"] = ("ag", wire.str,
                          self._codec.tag if self._codec else None,
                          self._shift)
        except BaseException as e:  # noqa: BLE001
            try:
                err_frame = dumps_oob(e)
            except Exception:
                err_frame = dumps_oob(RuntimeError(
                    f"{type(e).__name__}: {e}"))
        if err_frame is not None:
            hdr["err"] = bytes(err_frame)
        try:
            headers = self._exchange_headers(hdr)
            agreed = self._agree(headers, "allgather")
            if agreed is not None:
                self._raise(agreed)
            total = sum(h["n"] for h in headers.values())
            bounds = [self.seg_bounds(total, i) for i in range(self.size)]
            bad = sorted(
                o for o, h in headers.items()
                if h["n"] != (lambda b: b[1] - b[0])(
                    bounds[(o + self._shift) % self.size]))
            if bad:
                raise RuntimeError(
                    f"allgather shard lengths do not tile the flat "
                    f"value space: total {total}, offending rank(s) "
                    f"{bad} of {self.size} (every rank must pass "
                    f"exactly its seg_bounds(total) slice)")
            self._apply_tuned_chunk(total * wire.itemsize)
            buf = np.empty(total, wire)
            lo, hi = bounds[self.own]
            buf[lo:hi] = shard
            self._ag_phase(buf, bounds, wire)
            if layout is None or layout["total"] != total:
                return buf
            return rebuild_from_layout(buf, layout)
        except BaseException as e:  # noqa: BLE001 — flight recorder
            self._tr_err = e
            raise
        finally:
            self._finish("ag_round", t0)

    def broadcast(self, value, *, root: int = 0):
        """Pipelined ring broadcast of a FLAT array from ``root``: one
        header relay (root ships length + dtype; errors propagate like
        any other round) then the chunks flow root -> root+1 -> ... ->
        root-1, each intermediate rank forwarding VERBATIM — every
        rank ends holding bitwise-identical bytes. Non-root ranks pass
        ``value=None``. This is the hierarchical collective's fan-out
        phase (node leader -> members over shm); spans record kind
        "broadcast" with level tag "bcast" so timeline lanes can't
        cross-wire it with the reduce legs."""
        t0 = time.monotonic()
        hdr: Dict[str, Any] = {"origin": self.rank}
        err_frame = None
        arr = None
        try:
            self._begin(None, None, None,   # broadcasts ship raw bytes
                        kind="broadcast")
            if self._tr is not None and self._tr.cur is not None:
                self._tr.cur["level"] = "bcast"
                self._tr.options("bcast", None)
            root = int(root)
            if not 0 <= root < self.size:
                raise ValueError(
                    f"broadcast root {root} out of range for "
                    f"{self.size} ranks")
            if self.rank == root:
                arr = np.ascontiguousarray(np.asarray(value)).reshape(-1)
                hdr["bn"] = int(arr.size)
                hdr["bd"] = arr.dtype.str
            hdr["sig"] = ("bc", root)
        except BaseException as e:  # noqa: BLE001 — enters as error
            try:
                err_frame = dumps_oob(e)
            except Exception:
                err_frame = dumps_oob(RuntimeError(
                    f"{type(e).__name__}: {e}"))
        if err_frame is not None:
            hdr["err"] = bytes(err_frame)
        try:
            headers = self._exchange_headers(hdr)
            agreed = self._agree(headers, "broadcast")
            if agreed is not None:
                self._raise(agreed)
            rh = headers[root]
            n, dt = int(rh["bn"]), np.dtype(rh["bd"])
            self._ph = "bc"
            self._seg_tx = self._seg_rx = root
            if self.rank == root:
                for lo, hi in self._chunks(0, n, dt.itemsize):
                    self._write(arr[lo:hi].data.cast("B"))
                return arr
            buf = np.empty(n, dt)
            # the rank whose successor is the root terminates the chain
            forward = (self.rank + 1) % self.size != root
            for lo, hi in self._chunks(0, n, dt.itemsize):
                def apply(kind, mv, lo=lo, hi=hi):
                    if kind != DATA:
                        raise RingProtocolError(
                            f"unexpected frame kind {kind} in ring "
                            f"broadcast")
                    buf[lo:hi] = np.frombuffer(mv, dt)
                    return bytes(mv) if forward else None
                frame = self._read_with(apply)
                if forward:
                    self._write(frame)
            return buf
        except BaseException as e:  # noqa: BLE001 — flight recorder
            self._tr_err = e
            raise
        finally:
            self._finish("bc_round", t0)

    # --- data movement --------------------------------------------------

    def _data_phases(self, leaves, rebuild, wires, op):
        """Group leaves by wire dtype and run reduce-scatter+allgather
        once per group (deterministic first-appearance order, identical
        on every rank since the header phase validated leaf dtypes).
        Homogeneous pytrees — the common case — stay a single pass;
        mixed trees keep per-leaf accumulation exactness (an int64
        leaf never round-trips through float, a float32 leaf never
        pays float64 wire bytes)."""
        order: List[str] = []
        groups: Dict[str, List[int]] = {}
        for i, w in enumerate(wires):
            if w.str not in groups:
                order.append(w.str)
            groups.setdefault(w.str, []).append(i)
        outs: List[Optional[np.ndarray]] = [None] * len(leaves)
        for wstr in order:
            idxs = groups[wstr]
            reduced = self._reduce_group(
                [leaves[i] for i in idxs], np.dtype(wstr), op)
            for i, seg in zip(idxs, reduced):
                if not _keeps_wide(leaves[i].dtype, op):
                    seg = seg.astype(leaves[i].dtype, copy=False)
                outs[i] = seg
        return rebuild(iter(outs))

    def _flat_src(self, leaves, wire) -> Tuple[np.ndarray, int]:
        """Concatenate leaves into one flat wire-dtype vector (zero-copy
        when a single C-contiguous leaf already matches)."""
        total = int(sum(l.size for l in leaves))
        if len(leaves) == 1 and leaves[0].dtype == wire \
                and leaves[0].flags.c_contiguous:
            return leaves[0].reshape(-1), total
        src = np.empty(total, wire)
        off = 0
        for l in leaves:
            src[off:off + l.size] = np.asarray(
                l, dtype=wire).reshape(-1)
            off += l.size
        return src, total

    def _rs_phase(self, src, buf, bounds, wire, op):
        """The reduce-scatter phase: N-1 pipelined chunk steps; after
        them this rank holds the complete reduction of segment
        ``self.own`` in buf (NOT mean-divided — the caller owns that,
        it differs between the fused and standalone paths only in
        where it happens). Accumulation is fused
        (fuse(src, incoming, out=buf)) so buf needs no pre-fill, and
        always in the float32-or-wider wire dtype."""
        n, own = self.size, self.own
        itemsize = wire.itemsize
        fuse = {"sum": np.add, "mean": np.add,
                "max": np.maximum, "min": np.minimum}[op]
        # first-sent segment a0 = own - 1: each rank starts one segment
        # "behind" its owned one, so after N-1 accumulate-and-forward
        # steps the segment that lands complete is exactly `own`
        a0 = (own - 1) % n
        self._ph = "rs"
        for s in range(n - 1):
            send_seg = (a0 - s) % n
            recv_seg = (a0 - s - 1) % n
            self._seg_tx, self._seg_rx = send_seg, recv_seg
            frm = src if s == 0 else buf    # step 0 ships pristine input
            send_chunks = self._chunks(*bounds[send_seg], itemsize)
            recv_chunks = self._chunks(*bounds[recv_seg], itemsize)
            for k in range(max(len(send_chunks), len(recv_chunks))):
                if k < len(send_chunks):
                    lo, hi = send_chunks[k]
                    self._send_chunk(frm[lo:hi])
                if k < len(recv_chunks):
                    lo, hi = recv_chunks[k]

                    def apply(kind, mv, lo=lo, hi=hi):
                        if kind != DATA:
                            raise RingProtocolError(
                                f"unexpected frame kind {kind} in ring "
                                f"reduce-scatter")
                        if self._codec is not None:
                            inc = self._codec.decode(mv, hi - lo, wire)
                        else:
                            inc = np.frombuffer(mv, wire)
                        # fused init+accumulate: buf needs no pre-fill
                        fuse(src[lo:hi], inc, out=buf[lo:hi])
                    self._read_with(apply)

    def _ag_phase(self, buf, bounds, wire):
        """The allgather phase: this rank broadcasts its owned segment
        (complete in buf); received frames are forwarded VERBATIM, so
        codec payloads (int8 / bf16) are encoded exactly once — by the
        segment owner, which round-trips its own copy — and every rank
        reconstructs bitwise identical results."""
        n, own = self.size, self.own
        itemsize = wire.itemsize
        codec = self._codec
        outgoing: Optional[List[bytes]] = None
        if codec is not None:
            outgoing = []
            for lo, hi in self._chunks(*bounds[own], itemsize):
                frame = codec.encode(buf[lo:hi])
                # the owner applies its own encode/decode roundtrip so
                # its result matches what everyone else decodes
                buf[lo:hi] = codec.decode(frame, hi - lo, wire)
                outgoing.append(frame)
        self._ph = "ag"
        for s in range(n - 1):
            send_seg = (own - s) % n
            recv_seg = (own - s - 1) % n
            self._seg_tx, self._seg_rx = send_seg, recv_seg
            send_chunks = self._chunks(*bounds[send_seg], itemsize)
            recv_chunks = self._chunks(*bounds[recv_seg], itemsize)
            incoming: List[bytes] = []
            for k in range(max(len(send_chunks), len(recv_chunks))):
                if k < len(send_chunks):
                    if outgoing is not None:
                        self._write(outgoing[k])
                    else:
                        lo, hi = send_chunks[k]
                        self._write(buf[lo:hi].data.cast("B"))
                if k < len(recv_chunks):
                    lo, hi = recv_chunks[k]
                    if outgoing is not None:
                        kind, frame = self._read_bytes()
                        if kind != DATA:
                            raise RingProtocolError(
                                f"unexpected frame kind {kind} in ring "
                                f"allgather")
                        buf[lo:hi] = codec.decode(frame, hi - lo, wire)
                        incoming.append(frame)
                    else:
                        def apply(kind, mv, lo=lo, hi=hi):
                            if kind != DATA:
                                raise RingProtocolError(
                                    f"unexpected frame kind {kind} in "
                                    f"ring allgather")
                            buf[lo:hi] = np.frombuffer(mv, wire)
                        self._read_with(apply)
            if outgoing is not None:
                outgoing = incoming

    def _reduce_group(self, leaves, wire, op) -> List[np.ndarray]:
        """One reduce-scatter + allgather pass over leaves sharing one
        wire dtype; returns the reduced leaves (wire dtype, original
        shapes). This IS the fused allreduce: the same two standalone
        phases back to back over one flat buffer — no duplicated
        phase logic."""
        n = self.size
        src, total = self._flat_src(leaves, wire)
        self._apply_tuned_chunk(total * wire.itemsize)
        buf = np.empty(total, wire)         # filled by RS + AG below
        bounds = [self.seg_bounds(total, i) for i in range(n)]
        self._rs_phase(src, buf, bounds, wire, op)
        own_lo, own_hi = bounds[self.own]
        if op == "mean":
            buf[own_lo:own_hi] /= n
        self._ag_phase(buf, bounds, wire)
        # split back into per-leaf views of buf (cast-back to input
        # dtype happens in _data_phases, which knows the leaf policy)
        outs = []
        off = 0
        for l in leaves:
            outs.append(buf[off:off + l.size].reshape(l.shape))
            off += l.size
        return outs


# --- hierarchical (ring-of-rings) collectives ----------------------------


class _PoisonValue:
    """``np.asarray`` of this raises the carried exception — the hook
    for injecting an already-raised error into a collective leg's
    error-frame entry path: the leg's own prep try/except turns it
    into the err frame every peer agrees on in one header relay,
    instead of stalling them to the ring timeout."""

    def __init__(self, err: BaseException):
        self.err = err

    def __array__(self, *a, **kw):  # noqa: D105 — numpy hook
        raise self.err


def hier_seg_bounds(total: int, node_counts, world_rank: int):
    """(lo, hi) of ``world_rank``'s owned slice under the two-level
    split: the flat space is first split across nodes by the inter
    ring's even L-way split (total*i//L), then each node segment is
    split across its members by the intra ring's even k-way split.
    This nests EXACTLY with what the sub-rings' own ``seg_bounds``
    produce (the flat N-way split does not, for small totals), so
    hierarchical reduce-scatter shards always tile and validate."""
    counts = [int(c) for c in node_counts]
    L = len(counts)
    r = int(world_rank)
    node = 0
    while node < L and r >= counts[node]:
        r -= counts[node]
        node += 1
    if node >= L:
        raise ValueError(
            f"world rank {world_rank} out of range for nodes {counts}")
    base = total * node // L
    nlen = total * (node + 1) // L - base
    k = counts[node]
    return base + nlen * r // k, base + nlen * (r + 1) // k


def build_hier_specs(node_counts, intra_edge, inter_edge, *, op: str,
                     timeout_s: float, group: str,
                     quantize: Optional[str] = None,
                     chunk_bytes: Optional[int] = None,
                     tune: bool = False) -> List[Dict[str, Any]]:
    """THE ring-of-rings spec builder every plane shares (the train
    controller, the dag compiler, the bench): given per-node rank
    counts and two edge factories — ``intra_edge(i, j)`` returns the
    edge from local rank j to local rank (j+1)%k of node i,
    ``inter_edge(i)`` the edge from leader i to leader (i+1)%L — it
    emits one ``HierarchicalReducer.from_spec`` spec per world rank
    (world order), with codec/tuner options riding the INTER sub-spec
    only and distinct trace groups per sub-ring. One builder means
    the spec contract cannot drift between planes."""
    counts = [int(c) for c in node_counts]
    L = len(counts)
    intra_edges = [[intra_edge(i, j) for j in range(k)] if k > 1
                   else None for i, k in enumerate(counts)]
    inter_edges = [inter_edge(i) for i in range(L)]
    specs: List[Dict[str, Any]] = []
    for i, k in enumerate(counts):
        for j in range(k):
            intra = None
            if k > 1:
                intra = {"rank": j, "size": k, "op": op,
                         "timeout_s": timeout_s,
                         "chunk_bytes": chunk_bytes,
                         "group": f"{group}.n{i}", "level": "intra",
                         "to_next": intra_edges[i][j],
                         "from_prev": intra_edges[i][(j - 1) % k]}
            inter = None
            if j == 0:
                inter = {"rank": i, "size": L, "op": op,
                         "timeout_s": timeout_s,
                         "quantize": quantize,
                         "chunk_bytes": chunk_bytes,
                         "group": f"{group}.x", "level": "inter",
                         "tune": tune,
                         "to_next": inter_edges[i],
                         "from_prev": inter_edges[(i - 1) % L]}
            specs.append({"role": "hier", "rank": len(specs),
                          "size": sum(counts), "node": i, "local": j,
                          "nodes": counts, "op": op,
                          "timeout_s": timeout_s,
                          "quantize": quantize, "group": group,
                          "intra": intra, "inter": inter})
    return specs


class HierarchicalReducer:
    """Topology-aware two-level collective group: per-node intra rings
    (shm), one cross-node ring over elected node leaders (TCP), and an
    intra-node broadcast fan-out — the ring-of-rings decomposition of
    "The Big Send-off" (arxiv 2504.18658). Cross-node wire traffic
    drops to ~1/ranks-per-node of the flat ring's: only the leaders'
    node-combined values ride the inter ring, and the existing wire
    codecs (int8 block quantization, bf16 cast) apply on THAT leg only
    — shm legs ship full precision for free.

    Same collective surface as ``RingReducer`` (``reduce`` /
    ``reduce_scatter`` / ``allgather`` / ``round`` / ``seg_bounds`` /
    ``abort`` / ``step`` / ``timeout_s``), so the train plane,
    ``ShardedOptimizer`` and the dag ``_Collective`` use it
    interchangeably. Shard ownership follows ``hier_seg_bounds`` (the
    nested two-level split); results are bitwise identical on every
    rank — the inter ring's owner round-trip plus verbatim broadcast
    forwarding guarantee it whichever codec is active.

    One collective here is: intra reduce-scatter + intra allgather
    (node members combine into the node value, kept flat in the wide
    accumulation dtype), the inter leg over leaders, then an intra
    broadcast of the leader's result. An error in ANY leg — a dead
    leader mid-inter-ring included — is injected into every remaining
    leg as an error frame, so all world ranks surface the same failure
    (with their flight-recorder dumps) instead of stalling."""

    def __init__(self, *, node: int, local: int, node_counts,
                 intra: Optional[RingReducer],
                 inter: Optional[RingReducer],
                 op: str = "sum", timeout_s: float = 600.0,
                 quantize: Optional[str] = None, wire_dtype=None,
                 group: str = ""):
        self.node_counts = [int(c) for c in node_counts]
        self.nnodes = len(self.node_counts)
        if self.nnodes < 2:
            raise ValueError(
                "hierarchical collectives need at least 2 nodes — use "
                "a flat ring for single-node groups")
        self.node, self.local = int(node), int(local)
        self.size = sum(self.node_counts)
        self.rank = sum(self.node_counts[:self.node]) + self.local
        k = self.node_counts[self.node]
        if (intra is None) != (k == 1):
            raise ValueError(
                f"node {node} has {k} member(s): intra ring must be "
                f"{'absent' if k == 1 else 'present'}")
        if (inter is None) != (self.local != 0):
            raise ValueError(
                "exactly the node leaders (local rank 0) carry the "
                "inter ring")
        self.intra, self.inter = intra, inter
        self.op = op
        self.quantize = quantize
        self.wire_dtype = resolve_wire_dtype(wire_dtype)
        self.group = group
        self._timeout_s = float(timeout_s)
        self.timeout_s = self._timeout_s     # fan out to the legs
        self._layout = None
        self._step: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: Dict[str, Any],
                  abort=None) -> "HierarchicalReducer":
        """Attach both sub-rings from a controller/compiler-built spec:
        {"kind": "hier", "node", "local", "nodes": [k_0..k_L-1],
        "intra": ring spec | None, "inter": ring spec | None (leaders
        only), "op"?, "timeout_s"?, "quantize"?, "group"?}. The intra
        ring attaches first (consumer-first within each ring, as
        RingReducer.from_spec guarantees); an inter attach failure
        releases the intra channels instead of leaking them."""
        intra = RingReducer.from_spec(spec["intra"], abort=abort) \
            if spec.get("intra") else None
        inter = None
        try:
            inter = RingReducer.from_spec(spec["inter"], abort=abort) \
                if spec.get("inter") else None
        except BaseException:
            if intra is not None:
                intra.close()
            raise
        return cls(node=spec["node"], local=spec["local"],
                   node_counts=spec["nodes"], intra=intra, inter=inter,
                   op=spec.get("op", "sum"),
                   timeout_s=float(spec.get("timeout_s", 600.0)),
                   quantize=spec.get("quantize"),
                   wire_dtype=spec.get("wire_dtype"),
                   group=spec.get("group", ""))

    def _legs(self):
        return [g for g in (self.intra, self.inter) if g is not None]

    def channels(self) -> list:
        return [ch for g in self._legs() for ch in g.channels()]

    def close(self):
        for g in self._legs():
            g.close()

    def abort(self) -> None:
        for g in self._legs():
            g.abort()

    @property
    def step(self) -> Optional[int]:
        return self._step

    @step.setter
    def step(self, v: Optional[int]) -> None:
        self._step = v
        for g in self._legs():
            g.step = v

    @property
    def timeout_s(self) -> float:
        return self._timeout_s

    @timeout_s.setter
    def timeout_s(self, v: float) -> None:
        self._timeout_s = float(v)
        for g in self._legs():
            g.timeout_s = float(v)

    # -- topology ----------------------------------------------------------

    def seg_bounds(self, total: int, seg: Optional[int] = None):
        """(lo, hi) of segment ``seg`` (default: this rank's) under the
        nested two-level split — see ``hier_seg_bounds``."""
        s = self.rank if seg is None else int(seg)
        return hier_seg_bounds(total, self.node_counts, s)

    def _node_base(self, total: int) -> int:
        return total * self.node // self.nnodes

    # -- error relay -------------------------------------------------------

    def _relay_inter(self, err: BaseException) -> None:
        """Inject ``err`` into the inter ring (leaders only): the other
        leaders' in-flight leg resolves to this agreed error in one
        header relay, and their own relays fan it out to their node
        members."""
        if self.inter is None:
            return
        try:
            self.inter.reduce_scatter(_PoisonValue(err))
        except BaseException:  # noqa: BLE001 — original error wins
            pass

    def _relay_bcast(self, err: BaseException) -> None:
        """Inject ``err`` into the intra broadcast this node's members
        are (or will be) blocked in. Leader-only by construction —
        members never hold an error their node leader hasn't seen."""
        if self.intra is None or self.local != 0:
            return
        try:
            self.intra.broadcast(_PoisonValue(err), root=0)
        except BaseException:  # noqa: BLE001 — original error wins
            pass

    # -- collectives -------------------------------------------------------

    def reduce_scatter(self, value, *, op: Optional[str] = None,
                       quantize=_UNSET):
        """Hierarchical reduce-scatter: returns this rank's owned flat
        shard (``seg_bounds(total)`` under the nested split, mean
        already divided). ``quantize`` applies to the cross-node leg
        only. The layout is cached for a following ``allgather``."""
        op = op or self.op
        if op not in ("sum", "mean", "max", "min"):
            raise ValueError(f"unknown op {op!r}")
        q = self.quantize if quantize is _UNSET else quantize
        leg_op = "sum" if op == "mean" else op
        # 0. flatten ONCE: the staged flat vector feeds every leg (the
        #    legs' own flatten of a 1-D contiguous array is zero-copy)
        #    and its metadata feeds the final layout — device leaves
        #    pay exactly one device->host copy per sync. A local
        #    flatten failure enters the legs as a poison value, so it
        #    ships as an error frame every peer agrees on in one
        #    header relay instead of stalling them to the ring timeout.
        leaves = rebuild = None
        try:
            leaves, rebuild, _ = _flatten(value)
            w0 = _wire_dtype([l.dtype for l in leaves], leg_op) \
                if leaves else np.dtype(np.float32)
            entry = np.empty(int(sum(l.size for l in leaves)), w0)
            off = 0
            for l in leaves:
                entry[off:off + l.size] = np.asarray(
                    l, dtype=w0).reshape(-1)
                off += l.size
        except BaseException as e:  # noqa: BLE001 — enters poisoned
            entry = _PoisonValue(e)
        # 1. intra combine: node members reduce into the node value,
        #    kept flat in the wide accumulation dtype (shm; no codec)
        if self.intra is not None:
            try:
                ishard = self.intra.reduce_scatter(entry, op=leg_op)
                node_flat = self.intra.allgather(ishard, rebuild=False)
            except BaseException as e:  # noqa: BLE001 — relay onward
                self._relay_inter(e)
                raise
        else:
            node_flat = entry
        # 2. inter leg (leaders): reduce-scatter node values across
        #    nodes — the only wire leg, and the only codec'd one
        lead = None
        if self.inter is not None:
            try:
                lead = self.inter.reduce_scatter(
                    node_flat, op=leg_op,
                    quantize=q if q is not None else None)
                if op == "mean":
                    # world mean, applied identically on every leader
                    # BEFORE the broadcast so members receive final
                    # bytes (bitwise identity by construction)
                    lead = lead / self.size
            except BaseException as e:  # noqa: BLE001 — relay onward
                self._relay_bcast(e)
                raise
        # 3. intra fan-out of the leader's owned node segment
        if self.intra is not None:
            full_seg = self.intra.broadcast(lead, root=0)
        else:
            full_seg = lead
        # 4. layout + owned slice from the step-0 metadata (a poisoned
        #    entry never reaches here — the legs raised)
        total = int(sum(l.size for l in leaves))
        wide = full_seg.dtype
        self._layout = {
            "rebuild": rebuild, "total": total, "wire": wide,
            "leaves": [(l.shape, l.size,
                        wide if _keeps_wide(l.dtype, op) else l.dtype)
                       for l in leaves]}
        lo, hi = self.seg_bounds(total)
        base = self._node_base(total)
        return np.ascontiguousarray(
            full_seg[lo - base:hi - base]).copy()

    def allgather(self, shard, *, wire_dtype=_UNSET, total_hint=None,
                  rebuild: bool = True):
        """Hierarchical allgather: member shards gather over the intra
        ring into the node segment, leaders allgather node segments
        across the inter ring (``wire_dtype`` codec applies HERE
        only), and the full vector broadcasts back down. Layout-cache
        semantics match ``RingReducer.allgather`` (``total_hint`` pins
        the match, ``rebuild=False`` skips it)."""
        shard = np.ascontiguousarray(np.asarray(shard)).reshape(-1)
        layout = self._layout if rebuild else None
        if layout is not None:
            lo, hi = self.seg_bounds(layout["total"])
            if (layout["total"] != total_hint
                    if total_hint is not None
                    else hi - lo != shard.size):
                layout = None
        wire = layout["wire"] if layout is not None else shard.dtype
        shard = np.ascontiguousarray(shard, dtype=wire)
        wdt = self.wire_dtype if wire_dtype is _UNSET else wire_dtype
        # 1. intra gather: member shards tile the node segment under
        #    the nested split, which IS the intra ring's own split
        if self.intra is not None:
            try:
                node_seg = self.intra.allgather(shard, rebuild=False)
            except BaseException as e:  # noqa: BLE001 — relay onward
                self._relay_inter(e)
                raise
        else:
            node_seg = shard
        # 2. inter leg (leaders): node segments -> full vector
        full = None
        if self.inter is not None:
            try:
                full = self.inter.allgather(
                    node_seg,
                    wire_dtype=wdt if wdt is not None else _UNSET,
                    rebuild=False)
            except BaseException as e:  # noqa: BLE001 — relay onward
                self._relay_bcast(e)
                raise
        # 3. intra fan-out
        if self.intra is not None:
            full = self.intra.broadcast(full, root=0)
        if layout is None or layout["total"] != full.size:
            return full
        return rebuild_from_layout(full, layout)

    def reduce(self, value, *, op: Optional[str] = None,
               quantize=_UNSET, wire_dtype=_UNSET):
        """Fused hierarchical allreduce: the two standalone phases back
        to back (reduce-scatter caches the layout; allgather rebuilds
        the pytree with the flat ring's cast-back policy). ``quantize``
        rides the inter reduce-scatter, ``wire_dtype`` the inter
        allgather — cross-node leg only, results bitwise identical on
        every rank."""
        shard = self.reduce_scatter(value, op=op, quantize=quantize)
        return self.allgather(shard, wire_dtype=wire_dtype,
                              total_hint=self._layout["total"])

    def round(self, kind: int, value, err_frame: Optional[bytes], *,
              op: Optional[str] = None,
              quantize=_UNSET, wire_dtype=_UNSET):
        """Dag-loop entrypoint: (DATA, reduced_value) or (ERROR,
        frame). An error entry (or a local failure) resolves to the
        same agreed error on every world rank via the per-leg error
        relay; a dead neighbor raises RingPeerDead as usual."""
        if kind != DATA and err_frame is None:
            err_frame = dumps_oob(RuntimeError(
                "hier participant entered an error round without a "
                "frame"))
        if err_frame is not None:
            err = loads_oob(err_frame)
            if not isinstance(err, BaseException):
                err = RuntimeError(str(err))
            value = _PoisonValue(err)
        try:
            out = self.reduce(value, op=op, quantize=quantize,
                              wire_dtype=wire_dtype)
            return DATA, out
        except RingPeerDead:
            raise
        except BaseException as e:  # noqa: BLE001 — agreed error
            try:
                frame = dumps_oob(e)
            except Exception:
                frame = dumps_oob(RuntimeError(
                    f"{type(e).__name__}: {e}"))
            return ERROR, frame
