"""ZeRO shard redistribution for elastic worker groups.

When the group reshapes (a worker is lost, or an elastic grow lands),
the flat parameter space is re-split from N contiguous segments to M:
every surviving rank's optimizer-state shard must move to the new
``shard_bounds`` WITHOUT a round-trip through storage. The mechanism is
the one "Memory-efficient array redistribution through portable
collective communication" (arxiv 2112.01075) builds on: express the
redistribution as collectives the runtime already ships instead of
point-to-point tensor plumbing.

Planning lives here; execution rides ``RingReducer.reduce_scatter``
over the NEW ring: each contributor embeds the segments it holds (its
own old shard, plus any in-memory peer-checkpoint mirrors of lost
ranks' shards — see ``ShardedOptimizer.mirror_interval_steps``) into a
zero-filled flat vector and the group reduce-scatters with ``op="sum"``.
Contributions are disjoint by construction, so the sum is an exact
permutation-free move: every new rank receives precisely its new owned
slice, pipelined in chunks around the ring with the existing wire
codecs available. Per-rank wire cost is O(total) — the same as one
gradient reduce-scatter — regardless of how many segments moved.

``plan_reshard`` computes the minimal segment moves (old ``own`` map →
new) for observability and tests: the non-``local`` moves are the bytes
that genuinely cross ranks; everything else stays put.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ReshardError(RuntimeError):
    """A reshard cannot reconstruct the full flat space (a lost rank's
    segment has no surviving copy — own shard dead AND no peer mirror):
    the caller must fall back to a checkpoint restore."""


def shard_bounds(total: int, size: int, rank: int) -> Tuple[int, int]:
    """(lo, hi) of segment ``rank`` in the canonical contiguous
    ``size``-way FLAT split of a length-``total`` space — identical to
    ``RingReducer.seg_bounds`` and flat-ring
    ``TrainContext.shard_bounds``, duplicated here so planning stays
    importable without a ring. HIERARCHICAL groups own the nested
    split instead (``dag/ring.py hier_seg_bounds``): callers reasoning
    about a hier incarnation's old shards must use the ``old_nodes``
    counts the controller records in its lost-rank info."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for {size} shards")
    return total * rank // size, total * (rank + 1) // size


def all_bounds(total: int, size: int) -> List[Tuple[int, int]]:
    return [shard_bounds(total, size, r) for r in range(size)]


@dataclass(frozen=True)
class Move:
    """One contiguous segment move of the reshard plan: OLD rank ``src``
    holds [lo, hi) of the flat space, NEW rank ``dst`` owns it after the
    reshape. ``local`` moves need no wire (src survives AS dst)."""
    src: int
    dst: int
    lo: int
    hi: int
    local: bool

    @property
    def nbytes_f32(self) -> int:
        return 4 * (self.hi - self.lo)


def plan_reshard(total: int, old_size: int, new_size: int,
                 keep: Optional[Dict[int, int]] = None) -> List[Move]:
    """The minimal segment moves taking the old contiguous ``old_size``-
    way split of a flat length-``total`` space to the new ``new_size``-
    way split: for every (old rank, new rank) pair whose segments
    overlap, one Move covering exactly the overlap. ``keep`` maps
    surviving old ranks to their new rank (identity when omitted —
    a pure resize); a move whose source survives as its destination is
    tagged ``local`` (no wire). Zero-size segments (total < size)
    produce no moves, so plans stay exact for tiny values."""
    if keep is None:
        keep = {r: r for r in range(min(old_size, new_size))}
    moves: List[Move] = []
    for dst in range(new_size):
        nlo, nhi = shard_bounds(total, new_size, dst)
        if nlo >= nhi:
            continue
        for src in range(old_size):
            olo, ohi = shard_bounds(total, old_size, src)
            lo, hi = max(nlo, olo), min(nhi, ohi)
            if lo < hi:
                moves.append(Move(src=src, dst=dst, lo=lo, hi=hi,
                                  local=keep.get(src) == dst))
    return moves


def moved_bytes(moves: Sequence[Move], itemsize: int = 4) -> int:
    """Wire bytes a point-to-point realization of the plan would move
    (the non-local overlap); the collective realization pays O(total)
    per rank instead — report both when benchmarking."""
    return sum(itemsize * (m.hi - m.lo) for m in moves if not m.local)


def assign_recovery(dead: Sequence[int],
                    inventory: Dict[int, Dict[int, int]]) -> \
        Dict[int, Optional[int]]:
    """For each dead old rank, pick the surviving old rank that will
    contribute its in-memory mirror during the reshard collective —
    the freshest mirror (max step) wins; ``None`` when nobody holds
    one (that segment is unrecoverable in memory).

    ``inventory``: {survivor_old_rank: {mirrored_old_rank: step}} —
    what each survivor reported holding in its peer-checkpoint store."""
    out: Dict[int, Optional[int]] = {}
    for d in dead:
        best: Optional[int] = None
        best_step = -1
        for holder in sorted(inventory):
            step = inventory[holder].get(d)
            if step is not None and step > best_step:
                best, best_step = holder, step
        out[d] = best
    return out


def contribution(total: int, pieces: Sequence[Tuple[int, int, np.ndarray]],
                 dtype=np.float32) -> np.ndarray:
    """Embed disjoint flat segments into a zero-filled length-``total``
    vector — one contributor's input to the reshard reduce-scatter.
    Overlapping pieces would double-count under ``op="sum"``, so they
    are rejected loudly."""
    vec = np.zeros(total, dtype)
    filled: List[Tuple[int, int]] = []
    for lo, hi, arr in pieces:
        a = np.asarray(arr).reshape(-1)
        if hi - lo != a.size:
            raise ReshardError(
                f"piece [{lo}, {hi}) does not match its data "
                f"({a.size} elements)")
        if not 0 <= lo <= hi <= total:
            raise ReshardError(
                f"piece [{lo}, {hi}) outside the flat space [0, {total})")
        for flo, fhi in filled:
            if max(lo, flo) < min(hi, fhi):
                raise ReshardError(
                    f"pieces overlap at [{max(lo, flo)}, {min(hi, fhi)}) "
                    f"— contributions must be disjoint or the reshard "
                    f"sum double-counts")
        filled.append((lo, hi))
        vec[lo:hi] = a
    return vec


def coverage_gaps(total: int,
                  pieces: Sequence[Tuple[int, int]]) -> \
        List[Tuple[int, int]]:
    """Regions of [0, total) no piece covers — non-empty means the
    reshard would materialize zeros where state existed (the
    unrecoverable-segment signal for the local, ring-less path; the
    distributed path's coverage is checked controller-side from the
    mirror inventory before the reshape is even attempted)."""
    gaps: List[Tuple[int, int]] = []
    pos = 0
    for lo, hi in sorted(p[:2] for p in pieces):
        if lo > pos:
            gaps.append((pos, lo))
        pos = max(pos, hi)
    if pos < total:
        gaps.append((pos, total))
    return gaps


def exchange(group, total: int,
             pieces: Sequence[Tuple[int, int, np.ndarray]],
             dtype=np.float32) -> np.ndarray:
    """Execute one flat-space reshard: this rank contributes ``pieces``
    (disjoint [lo, hi) segments it holds — its old shard plus any
    mirrors it recovers) and receives its NEW owned slice.

    ``group`` is a ``RingReducer``-shaped collective over the NEW ring
    (``reduce_scatter``/``seg_bounds``); ``None`` runs the degenerate
    single-survivor path locally, where the pieces must cover the whole
    space (there is nobody else to supply the rest)."""
    if group is None:
        gaps = coverage_gaps(total, [(lo, hi) for lo, hi, _ in pieces])
        if gaps:
            raise ReshardError(
                f"single-rank reshard cannot reconstruct segments "
                f"{gaps} — no surviving copy (fall back to checkpoint "
                f"restore)")
        return contribution(total, pieces, dtype)
    vec = contribution(total, pieces, dtype)
    out = group.reduce_scatter(vec, op="sum")
    return np.asarray(out, dtype=dtype)
