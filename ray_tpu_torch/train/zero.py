"""ZeRO-1: optimizer states sharded across the train worker group.

The host-plane realization of "Automatic Cross-Replica Sharding of
Weight Update in Data-Parallel Training" (arxiv 2004.13336): instead of
every data-parallel worker materializing the FULL averaged gradient,
keeping FULL Adam moments, and applying the FULL weight update —
N-way redundant memory and FLOPs — the flat parameter space is split
into N contiguous shards and each rank:

  1. **reduce-scatters** gradients over the chunked ring
     (dag/ring.py): receives only the averaged gradient for ITS shard,
     at the same per-rank wire cost as half an allreduce;
  2. updates optimizer moments **for the local shard only** — moment
     memory and optimizer FLOPs drop to 1/N per host;
  3. **allgathers** updated parameters back to the full pytree, with
     opt-in ``param_wire_dtype="bfloat16"`` (half the fp32 bytes; the
     shard owner round-trips its own copy so every rank stays bitwise
     identical — parameters cannot diverge across SPMD workers).

Total wire per step drops from 2·S fp32-equivalents (allreduce) to
1·S fp32 + 1·S bf16 ≈ 0.75x with bf16 allgather, and composes with
``grad_quantize="int8"`` reduce-scatter for ≈0.45x. See PERF_JAX.md
"Sharded optimizer (ZeRO-1)" for the measured table.

Usage inside a train_fn (drop-in around any optax transformation)::

    opt = zero.ShardedOptimizer(optax.adamw(3e-4),
                                param_wire_dtype="bfloat16")
    state = opt.init(params)
    for batch in shard:
        grads = grad_fn(params, batch)          # full local gradients
        params, state = opt.update(grads, state, params)

Unlike a bare optax ``GradientTransformation``, ``update`` returns the
NEW PARAMETERS (not updates): the allgather reassembles post-update
parameters directly, so there is nothing left to apply.

The port's copy of ``ray_tpu/train/zero.py``, in steady state. The
wrapped transformation is anything optax-shaped: optax's own (the
reference tests wrap ``optax.adamw``/``sgd``) or the port's
``parallel.mesh.ShardAdamW``, which runs the shard's AdamW on a torch
device. Parameters and gradients may be torch tensors on any device:
they are staged to the host as the train plane stages them
(train/collective.py ``_stage``), and the new parameters come back as
tensors of each leaf's dtype on its device. A wrapped transformation
with ``clip_by_global_norm`` set is handed the norm of the WHOLE
averaged gradient (one scalar sum of the shards' squared norms over the
same ring), so a clipped ZeRO step equals the replicated step; the
reference hands its wrapped chain only this rank's shard, so a
``clip_by_global_norm`` inside it clips by the shard's norm (ROADMAP
Queue 3, R3). The peer mirrors and the in-place ``reshard`` of the
elastic reshape wait for ROADMAP Queue 1 item 13b."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from ray_tpu_torch.dag.ring import (_UNSET, _flatten, _numel,
                                    _wire_dtype, rebuild_from_layout,
                                    resolve_wire_dtype, to_host, unflat,
                                    wire_roundtrip)
from ray_tpu_torch.util import goodput


def zero_metrics() -> dict:
    """Get-or-create the ZeRO series (process-global registry; pushed
    to the head like every other worker metric).

      optim_shard_bytes     bytes of optimizer state (moments,
                            counters) held by THIS rank —
                            ≈ replicated_bytes / N
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "shard_bytes": m.Gauge(
            "optim_shard_bytes",
            "Optimizer-state bytes (moments, counters) held by this "
            "rank under ZeRO-1 sharding — about 1/world_size of the "
            "replicated-optimizer footprint"),
    }


def _tree_bytes(tree) -> int:
    from ray_tpu_torch.train.collective import _leaf_nbytes, _raw_leaves
    return int(sum(_leaf_nbytes(l) for l in _raw_leaves(tree)))


def _flat(value, wire: np.dtype) -> Tuple[np.ndarray, Any, int, list]:
    """(flat wire-dtype vector, rebuild closure, total, leaves) for a
    host pytree — the same flatten order the ring's collectives use
    (also the single source for train/collective.py's world_size==1
    paths, so the flatten/cast policy cannot drift between them)."""
    leaves, rebuild, _ = _flatten(value)
    total = int(sum(l.size for l in leaves))
    flat = np.empty(total, wire)
    off = 0
    for l in leaves:
        flat[off:off + l.size] = np.asarray(l, dtype=wire).reshape(-1)
        off += l.size
    return flat, rebuild, total, leaves


def _slice_leaves(leaves: list, wire: np.dtype, lo: int,
                  hi: int) -> np.ndarray:
    """The [lo, hi) slice of the flat wire-dtype vector WITHOUT
    materializing the whole flat space — the sharded update only ever
    touches this rank's owned slice, and a full O(S) copy per step is
    exactly the redundancy ZeRO exists to remove."""
    from ray_tpu_torch.dag.ring import stage_leaf
    out = np.empty(max(0, hi - lo), wire)
    off = pos = 0
    for l in leaves:
        n = _numel(l)
        a, b = max(lo, off), min(hi, off + n)
        if a < b:
            # a torch leaf is sliced where it lives, then staged
            seg = stage_leaf(l.reshape(-1)[a - off:b - off])
            out[pos:pos + (b - a)] = seg.astype(wire, copy=False)
            pos += b - a
        off += n
    return out


def _param_leaves(params):
    """``(leaves, finish)``: the parameter leaves in ``_flatten``'s order
    and the function that rebuilds new parameters from the flat
    wire-dtype vector. Torch leaves stay where they live (only the owned
    slice is ever staged, ``_slice_leaves``) and come back as tensors of
    their dtype on their device; numpy leaves as the reference's."""
    from ray_tpu_torch.train.collective import _raw_leaves, _tensor_like
    if _tensor_like(params) is not None:
        return _raw_leaves(params), lambda flat: unflat(flat, params)
    leaves, rebuild, _ = _flatten(params)
    return leaves, lambda flat: rebuild_from_layout(flat, {
        "rebuild": rebuild,
        "leaves": [(l.shape, l.size, l.dtype) for l in leaves]})


def _host_grads(grads):
    """The gradients on the host for one unbucketed step: torch leaves
    copied straight into one flat float32 vector (``stage_flat``: no
    second copy when the ring flattens it), anything else leaf by
    leaf."""
    from ray_tpu_torch.dag.ring import stage_flat
    flat, _ = stage_flat(grads)
    return flat if flat is not None else to_host(grads)[0]


class ShardedOptimizer:
    """ZeRO-1 wrapper around an optax ``GradientTransformation``.

    ``init(params)`` allocates optimizer state for this rank's shard
    only; ``update(grads, state, params)`` runs the reduce-scatter →
    local-shard update → allgather step and returns
    ``(new_params, new_state)``.

    ``group`` is the collective to shard over — anything shaped like
    ``dag/ring.py RingReducer`` (``reduce_scatter`` / ``allgather`` /
    ``seg_bounds`` / ``size``). Default: the train context's
    controller-wired gradient-sync ring, resolved lazily at the first
    ``init``/``update`` — so constructing the optimizer outside a
    train_fn is free, and world_size == 1 groups run the whole update
    locally (same results, no ring).

    Options:
      param_wire_dtype: "bfloat16" ships the parameter allgather in
        bf16 (≈0.75x total step wire vs fp32 allreduce); one ~2^-8
        relative rounding per step, applied identically on every rank.
      grad_quantize: "int8" block-quantizes the gradient
        reduce-scatter (the EQuARX-style wire format, dag/ring.py) —
        for cross-host rings where bytes are the bottleneck. "int4"
        packs two values per byte (~13% of the fp32 wire) and should
        only run with error feedback on.
      error_feedback: carry the per-rank quantization residual
        (compensated-minus-shipped, reconstructed from the local
        codec round-trip — no extra wire) into the next step's
        gradients, making lossy grad_quantize convergence-safe
        (the JAX package's ZERO_BENCH.json, codec_convergence:
        int4+EF tracks the fp32 loss trajectory within 1e-3 relative;
        no-EF int8 does not). None
        defers to Config.codec_error_feedback (on by default) whenever
        grad_quantize is lossy. The residual is keyed to the ring
        generation: an elastic ``reshard()`` provably zeroes it —
        never reuses a stale one.
      mirror_interval_steps: the reference's in-memory peer
        checkpoints of the state shard for the elastic reshard; only 0
        (off) is ported — a positive interval raises naming ROADMAP
        Queue 1 item 13b.
      bucket_bytes: split the gradient sync into leaf buckets of
        about this size and PIPELINE them — the ring starts reducing
        early buckets while later gradients are still being staged to
        host (the hidden staging time lands in the
        ``allreduce_bucket_overlap_s`` histogram). The optimizer
        shard becomes the concatenation of per-bucket owned slices
        (still 1/N of the space; all ranks stay bitwise identical —
        vs the unbucketed step only the ring's reduction order over
        each element can differ, the usual reshape rounding).
        Incompatible with ``mirror_interval_steps``/``reshard`` (the
        elastic plane assumes one contiguous shard): bucketed
        optimizers recover via checkpoint restore.
    """

    def __init__(self, opt, *, param_wire_dtype: Optional[str] = None,
                 grad_quantize: Optional[str] = None, group=None,
                 error_feedback: Optional[bool] = None,
                 mirror_interval_steps: int = 0,
                 bucket_bytes: Optional[int] = None):
        if not hasattr(opt, "init") or not hasattr(opt, "update"):
            raise TypeError(
                "ShardedOptimizer wraps an optax-style transformation "
                "with init/update, got " + type(opt).__name__)
        self.opt = opt
        self.param_wire_dtype = resolve_wire_dtype(param_wire_dtype)
        if grad_quantize not in (None, "int8", "int4"):
            raise ValueError(
                f"grad_quantize must be None, 'int8' or 'int4', "
                f"got {grad_quantize!r}")
        self.grad_quantize = grad_quantize
        if error_feedback and grad_quantize is None:
            raise ValueError(
                "error_feedback compensates a lossy grad_quantize "
                "codec — pass grad_quantize='int8'/'int4' with it")
        self.error_feedback = error_feedback
        self._ef = None      # lazily built ErrorFeedback accumulator
        if mirror_interval_steps < 0:
            raise ValueError("mirror_interval_steps must be >= 0")
        self.mirror_interval_steps = int(mirror_interval_steps)
        if bucket_bytes is not None and bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be > 0")
        if bucket_bytes and mirror_interval_steps:
            raise ValueError(
                "bucket_bytes is incompatible with "
                "mirror_interval_steps: peer checkpoints and the "
                "elastic reshard assume one contiguous shard — "
                "bucketed optimizers recover via checkpoint restore")
        if mirror_interval_steps:
            raise NotImplementedError(_UNPORTED_ELASTIC)
        self.bucket_bytes = bucket_bytes
        self._g = group
        self._g_resolved = group is not None
        # generation of the train context the group was resolved
        # against; None = explicit group (no elastic bookkeeping)
        self._gen: Optional[int] = None if group is None else -1
        self._m = zero_metrics()
        self._step = 0      # collective-span train-step tag (tracing)
        self._bounds: Optional[Tuple[int, int]] = None
        # the norm of the whole averaged gradient of the last update,
        # where the wrapped transformation clips by it (else None)
        self.grad_norm: Optional[float] = None

    # -- group resolution --------------------------------------------------

    def _ctx(self):
        from ray_tpu_torch.train.api import get_context
        try:
            return get_context()
        except RuntimeError:         # plain script, no train_fn: local
            return None

    def _group(self):
        """The ring to shard over, or None for a fully-local update
        (world_size == 1, or no train context at all)."""
        if not self._g_resolved:
            ctx = self._ctx()
            # attach under the peer-lost wrap too: a death (or rewire
            # abort) DURING the first attach must surface as the same
            # typed PeerLostError the recovery loop catches
            self._g = None if ctx is None or ctx.get_world_size() == 1 \
                else self._wrap_peer_lost(ctx.gradient_sync_ring)
            self._g_resolved = True
            self._gen = None if ctx is None \
                else int(getattr(ctx, "generation", 0))
        return self._g

    def _check_generation(self):
        """A rewire (elastic reshape) invalidates the cached ring AND
        the shard split this optimizer's state lives on — an update
        against the stale split would be wrong on every rank. Callers
        must reshard() first; explicit-group optimizers (gen -1) and
        ring-less ones are exempt."""
        if self._gen is None or self._gen < 0:
            return
        ctx = self._ctx()
        if ctx is not None and \
                int(getattr(ctx, "generation", 0)) != self._gen:
            raise RuntimeError(
                "worker group was reshaped since this optimizer last "
                "resolved its collective — call "
                "ShardedOptimizer.reshard(state) after "
                "train.await_regroup() before the next update")

    def _wrap_peer_lost(self, fn):
        """Surface a ring neighbor's death as the typed error elastic
        train_fns catch (train.PeerLostError), via the one shared
        conversion (collective.peer_lost_error) so message and
        attribute shape can't drift from the _ring_call path."""
        from ray_tpu_torch.dag.ring import RingPeerDead
        try:
            return fn()
        except RingPeerDead as e:
            from ray_tpu_torch.train.collective import peer_lost_error
            raise peer_lost_error(e) from e

    def shard_bounds(self, total: int) -> Tuple[int, int]:
        """This rank's owned (lo, hi) slice of the flat length-``total``
        parameter space (the whole space when unsharded)."""
        g = self._group()
        return (0, total) if g is None else g.seg_bounds(total)

    # -- error feedback ----------------------------------------------------

    def _ef_enabled(self) -> bool:
        if self.grad_quantize is None:
            return False
        if self.error_feedback is not None:
            return bool(self.error_feedback)
        from ray_tpu_torch.config import get_config
        return bool(getattr(get_config(), "codec_error_feedback", True))

    def _ef_for(self, g, total: int):
        """The error-feedback accumulator keyed to the CURRENT ring
        generation (and size — an explicit-group optimizer has no
        generation bookkeeping but a differently-sized group is still
        a different wire), or None when EF is off. The ``ensure`` call
        re-zeroes the residual whenever the key moved — a reshard can
        never silently reuse the old split's residual."""
        if not self._ef_enabled():
            return None
        from ray_tpu_torch.train.collective import ErrorFeedback
        if self._ef is None:
            self._ef = ErrorFeedback()
        self._ef.ensure(gen=(self._gen, getattr(g, "size", 0)),
                        total=int(total), tag=self.grad_quantize)
        return self._ef

    # -- optax-compatible surface ------------------------------------------

    def _bucket_layout(self, leaves):
        """Per-bucket (leaf_lo, leaf_hi, total, owned_lo, owned_hi)
        under the configured ``bucket_bytes`` — every rank derives the
        identical cut from the layout alone."""
        from ray_tpu_torch.train.collective import _bucket_parts
        out = []
        for a, b in _bucket_parts(leaves, self.bucket_bytes):
            tot = int(sum(_numel(l) for l in leaves[a:b]))
            lo, hi = self.shard_bounds(tot)
            out.append((a, b, tot, lo, hi))
        return out

    def init(self, params):
        """Optimizer state for this rank's parameter shard only —
        moment memory is 1/world_size of the replicated footprint
        (exported as the ``optim_shard_bytes`` gauge)."""
        leaves, _ = _param_leaves(params)
        wire = self._wire_of(leaves)
        total = int(sum(_numel(l) for l in leaves))
        self._total = total
        if self.bucket_bytes:
            # the shard is the concatenation of per-bucket owned
            # slices (non-contiguous in the full flat space, so the
            # single-slice _bounds bookkeeping stays unset)
            self._bounds = None
            shard = np.concatenate(
                [_slice_leaves(leaves[a:b], wire, lo, hi)
                 for a, b, _, lo, hi in self._bucket_layout(leaves)]) \
                if leaves else np.empty(0, wire)
            state = self.opt.init(shard)
            self._m["shard_bytes"].set(_tree_bytes(state))
            return state
        lo, hi = self.shard_bounds(total)
        self._bounds = (lo, hi)
        state = self.opt.init(_slice_leaves(leaves, wire, lo, hi))
        self._m["shard_bytes"].set(_tree_bytes(state))
        return state

    def update(self, grads, state, params):
        """One ZeRO-1 step: reduce-scatter mean gradients (each rank
        receives only its averaged shard), update the local shard's
        moments and parameters, allgather the updated parameters.
        Returns ``(new_params, new_state)`` — new_params is the full
        pytree, bitwise identical on every rank."""
        if params is None:
            raise ValueError(
                "ShardedOptimizer.update needs params (the allgather "
                "reassembles updated parameters, not updates)")
        self._check_generation()
        g = self._group()
        if g is not None and hasattr(g, "step"):
            # both halves of this update (RS + AG) trace as one step —
            # the timeline's ring lanes group by it, and a straggler
            # row names the step it stalled
            g.step = self._step
        if g is not None:
            ctx = self._ctx()
            if ctx is not None:
                # forensics front door (ledger intent row + opt-in
                # pre-flight options agreement): one check covers both
                # halves of the update — the RS and AG ride the same
                # option set, so a desync would already differ here
                from ray_tpu_torch.train.collective import _pre_collective
                _pre_collective(
                    ctx, "zero_update",
                    f"zero_update:quantize={self.grad_quantize}:"
                    f"wire={self.param_wire_dtype}:"
                    f"bucket={self.bucket_bytes}")
        # ONE structure walk per step: leaves feed the wire dtype, the
        # total, the owned-slice copy, and the final rebuild (torch
        # leaves: only the owned slice crosses to the host, and the new
        # parameters go back to their devices; the gradients cross in
        # one flat vector, or bucket by bucket when bucketed)
        leaves, finish = _param_leaves(params)
        wire = self._wire_of(leaves)
        total = int(sum(_numel(l) for l in leaves))
        if getattr(self, "_total", total) != total:
            raise ValueError(
                f"parameter count changed since init: "
                f"{self._total} -> {total}")
        if g is not None and self.bucket_bytes:
            return self._update_bucketed(grads, state, leaves, finish,
                                         wire, g)
        grads = _host_grads(grads)
        if g is None:
            gshard, _, gtotal, _ = _flat(grads, wire)
            lo, hi = 0, total
            if gtotal != total:
                raise ValueError(
                    "gradient layout does not match the parameter "
                    "layout")
        else:
            ef = self._ef_for(g, total)
            pend = None
            if ef is not None:
                if isinstance(grads, np.ndarray) and grads.ndim == 1 \
                        and grads.dtype == np.float32:
                    gflat, gtotal = grads, grads.size  # staged: no copy
                else:
                    gflat, _, gtotal, _ = _flat(grads,
                                                np.dtype(np.float32))
                if gtotal != total:
                    raise ValueError(
                        "gradient layout does not match the parameter "
                        "layout")
                send = ef.compensate(gflat)
                gflat = grads = None    # the staged copy is in send now
                pend = ef.pending(send, self.grad_quantize)
            else:
                send = grads
            # the host copies of the gradients live only until they ship
            grads = None
            gshard = np.asarray(self._wrap_peer_lost(
                lambda: g.reduce_scatter(
                    send, op="mean",
                    quantize=self.grad_quantize
                    if self.grad_quantize is not None else _UNSET)),
                dtype=wire)
            send = None
            if ef is not None:
                # commit only after the round shipped: a raise above
                # leaves the residual untouched, so a same-key retry
                # re-compensates the identical stream instead of
                # double-compensating a round that never reached the
                # wire
                ef.commit(pend)
            lo, hi = g.seg_bounds(total)
            if gshard.size != hi - lo:
                raise ValueError(
                    "gradient layout does not match the parameter "
                    "layout (reduce-scattered shard has "
                    f"{gshard.size} elements, owned param slice has "
                    f"{hi - lo})")
        # only this rank's owned param slice is materialized — the rest
        # of the flat space never gets copied (that is the point of
        # sharding the update)
        pshard = _slice_leaves(leaves, wire, lo, hi)
        # the shard's optimizer math is this step's host-side compute
        # (the collectives around it attribute their own exposed wait)
        kw = self._clip_kwargs(g, gshard)
        with goodput.interval("compute"):
            updates, new_state = self.opt.update(gshard, state, pshard,
                                                 **kw)
            new_shard = pshard + np.asarray(updates, dtype=wire)
        if g is None:
            new_flat = new_shard
            if self.param_wire_dtype is not None:
                # parity with the sharded path: a 1-worker run applies
                # the same single bf16 rounding event per step
                new_flat = wire_roundtrip(new_flat,
                                          self.param_wire_dtype)
        else:
            # flat gather (rebuild=False): the PYTREE is rebuilt below
            # from the PARAMETER leaves — the ring's cached layout
            # carries the GRADIENT leaf dtypes, which may be narrower
            new_flat = np.asarray(self._wrap_peer_lost(
                lambda: g.allgather(
                    new_shard,
                    wire_dtype=self.param_wire_dtype
                    if self.param_wire_dtype is not None else _UNSET,
                    rebuild=False)), dtype=wire)
        new_params = finish(new_flat)
        self._step += 1
        self._bounds = (lo, hi)
        return new_params, new_state

    def _clip_kwargs(self, g, gshard: np.ndarray) -> dict:
        """``{"grad_norm": n}`` for a wrapped transformation that clips by
        the global norm (``clip_by_global_norm`` set, as
        ``parallel.mesh.ShardAdamW``): ``n`` is the norm of the WHOLE
        averaged gradient — each rank's squared shard norm (the
        transformation's own ``sq_norm``), summed over the ring, so
        every rank clips by the same bitwise scalar. Empty for
        transformations without it (optax's take no such argument)."""
        if not getattr(self.opt, "clip_by_global_norm", None):
            return {}
        sq = np.array([self.opt.sq_norm(gshard)], np.float64)
        if g is not None:
            sq = np.asarray(self._wrap_peer_lost(
                lambda: g.reduce(sq, op="sum")), np.float64)
        self.grad_norm = float(np.sqrt(sq[0]))
        return {"grad_norm": self.grad_norm}

    def _update_bucketed(self, grads, state, leaves, finish, wire, g):
        """One bucketed ZeRO-1 step: per-bucket reduce-scatter rounds
        pipelined against gradient staging (early buckets reduce while
        later grads are still being staged to host), ONE optimizer
        update over the concatenated bucket shards, then per-bucket
        parameter allgathers. Numerically identical to the unbucketed
        step modulo the shard partitioning — each element reduces the
        same way, just inside its bucket's round."""
        from ray_tpu_torch.train.collective import (_pipeline_buckets,
                                                    _raw_leaves, _stage)
        buckets = self._bucket_layout(leaves)
        graw = _raw_leaves(grads)
        if len(graw) != len(leaves):
            raise ValueError(
                "gradient layout does not match the parameter layout")
        q = self.grad_quantize if self.grad_quantize is not None \
            else _UNSET
        total = int(sum(t for _, _, t, _, _ in buckets))
        ef = self._ef_for(g, total)
        offs = [0]
        for _, _, t, _, _ in buckets:
            offs.append(offs[-1] + t)

        pend: dict = {}

        def stage(i):
            a, b = buckets[i][0], buckets[i][1]
            if ef is None:
                return [_stage(l) for l in graw[a:b]]
            # EF stages the bucket as ONE flat fp32 slice: this bucket
            # owns exactly its residual slice of the flat space, and
            # the round-trip covers the same slice its frames ship
            seg = np.concatenate(
                [_stage(l).astype(np.float32, copy=False).reshape(-1)
                 for l in graw[a:b]]) if b > a \
                else np.empty(0, np.float32)
            comp = ef.compensate(seg, offset=offs[i])
            pend[i] = ef.pending(comp, self.grad_quantize)
            return comp

        def rs(i, staged):
            out = self._wrap_peer_lost(
                lambda: g.reduce_scatter(staged, op="mean", quantize=q))
            if ef is not None:
                # this bucket's frames shipped — its slice is real
                ef.commit(pend.pop(i), offset=offs[i])
            return out

        try:
            outs, _ = _pipeline_buckets(len(buckets), stage, rs)
        except BaseException:
            if ef is not None:
                # some buckets shipped, some did not: the residual's
                # slices describe different rounds — zero it rather
                # than let a retry double-compensate the shipped part
                ef.invalidate()
            raise
        lens = [hi - lo for _, _, _, lo, hi in buckets]
        for o, ln in zip(outs, lens):
            if np.asarray(o).size != ln:
                raise ValueError(
                    "gradient layout does not match the parameter "
                    "layout (bucketed shard sizes differ)")
        gshard = np.concatenate(
            [np.asarray(o, dtype=wire) for o in outs]) \
            if outs else np.empty(0, wire)
        pshard = np.concatenate(
            [_slice_leaves(leaves[a:b], wire, lo, hi)
             for a, b, _, lo, hi in buckets]) \
            if buckets else np.empty(0, wire)
        kw = self._clip_kwargs(g, gshard)
        with goodput.interval("compute"):
            updates, new_state = self.opt.update(gshard, state, pshard,
                                                 **kw)
            new_shard = pshard + np.asarray(updates, dtype=wire)
        pieces, off = [], 0
        for ln in lens:
            pieces.append(np.ascontiguousarray(new_shard[off:off + ln]))
            off += ln
        wdt = self.param_wire_dtype
        fulls, _ = _pipeline_buckets(
            len(pieces), lambda i: pieces[i],
            lambda i, piece: self._wrap_peer_lost(
                lambda: g.allgather(
                    piece,
                    wire_dtype=wdt if wdt is not None else _UNSET,
                    rebuild=False)))
        # bucket cuts are leaf-aligned: per-bucket flats concatenate
        # into the full flat value space in order
        new_flat = np.concatenate(
            [np.asarray(f, dtype=wire).reshape(-1) for f in fulls]) \
            if fulls else np.empty(0, wire)
        new_params = finish(new_flat)
        self._step += 1
        return new_params, new_state

    # -- elastic reshard ---------------------------------------------------

    def reshard(self, state):
        """The in-place redistribution of the state shards after an
        elastic reshape (``train.await_regroup``) waits for ROADMAP Queue
        1 item 13b with the peer mirrors it rebuilds lost shards from;
        a bucketed optimizer refuses it as the reference does."""
        from ray_tpu_torch.train import reshard as _rs
        if self.bucket_bytes:
            raise _rs.ReshardError(
                "bucketed ShardedOptimizer cannot reshard in place "
                "(per-bucket shards are not one contiguous segment of "
                "the flat space) — let this propagate so the "
                "controller restores from checkpoint")
        raise NotImplementedError(_UNPORTED_ELASTIC)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _wire_of(leaves: list) -> np.dtype:
        from ray_tpu_torch.train.collective import _np_dtype
        return _wire_dtype([_np_dtype(l) for l in leaves], "mean") \
            if leaves else np.dtype(np.float32)


_UNPORTED_ELASTIC = (
    "the elastic reshape of a ShardedOptimizer (peer mirrors, "
    "mirror_interval_steps > 0, reshard()) is not ported to "
    "ray_tpu_torch yet (ROADMAP Queue 1 item 13b)")
