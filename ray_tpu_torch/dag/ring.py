"""Pytree flattening for the host plane (no jax import).

The port's copy of the helpers of ``ray_tpu/dag/ring.py`` that the
port's code uses: ``_flatten`` and ``rebuild_from_layout`` (the
checkpoint plane, ``train/ckptio.py``), and ``accumulation_dtype`` and
``_keeps_wide``, the low-precision promotion policy of the DAG's star
reduce (``dag/runtime.py`` ``_tree_reduce``). The ring collectives,
codecs, tracing and wire dtypes of that module come with the gradient
ring (ROADMAP.md, Queue 1 item 13).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np


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


def accumulation_dtype(dt: np.dtype, op: str) -> Optional[np.dtype]:
    """THE low-precision promotion policy of the star's per-leaf reduce
    (runtime._tree_reduce), shared in the reference with the ring's wire
    dtype. None = reduce in the input dtype. sum over sub-64-bit ints
    accumulates in int64; mean over integers accumulates in float64
    (and the RESULT stays float64, matching numpy's int/len division —
    means of ints must not truncate); sub-32-bit floats (fp16, and
    bfloat16/fp8 which register as kind 'V') accumulate in float32."""
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
