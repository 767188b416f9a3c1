"""Pytree flattening for the host plane (no jax import).

The port's copy of the two helpers of ``ray_tpu/dag/ring.py`` that the
checkpoint plane (``train/ckptio.py``) uses: ``_flatten`` and
``rebuild_from_layout``. The ring collectives, codecs and tracing of
that module come with the gradient ring (ROADMAP.md, Queue 1 item 13).
"""

from __future__ import annotations

from typing import Any, List, Tuple

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
