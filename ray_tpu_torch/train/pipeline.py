"""MPMD pipeline parallelism: microbatch schedules over dag actors.

The missing parallelism axis (reference: "Scaling Deep Learning Training
with MPMD Pipeline Parallelism", arxiv 2412.14374 — per-stage programs
driven by a microbatch schedule, activations crossing stage boundaries
over the data plane): a model too big for one host is split into S
**stages**, each a dag actor running its stage's program, and the global
batch is split into M **microbatches** that flow stage 0 -> 1 -> ... ->
S-1 (forward) and back (backward). Activations and activation-gradients
ride the SAME placement-aware shm/TCP channels the compiled-dag plane
uses (dag/channel.py — shm when co-located, TCP across nodes),
optionally as device-path ``TensorRef`` handles (runtime/device_store.py:
only the small handle crosses the channel).

This module COMPILES the schedule; ``dag/runtime.py pipe_exec_loop``
EXECUTES it inside each stage actor with the dag plane's per-item
recv/compute overlap windows, so stage p's recv of microbatch i+1 hides
under its compute of microbatch i.

Schedules:

  **gpipe**   all M forwards, then all M backwards (reverse order).
              Simple, but every stage holds M in-flight microbatch
              inputs at the fill/drain turn — memory O(M).
  **1f1b**    (default; PipeDream-flush) stage p runs min(M, S-1-p)
              warmup forwards, then alternates one-forward-one-backward
              in steady state, then drains the remaining backwards.
              In-flight microbatches at stage p never exceed S-p —
              steady-state memory O(stages), independent of M, with the
              SAME bubble fraction as GPipe: (S-1)/(M+S-1).
  **interleaved**  each worker holds ``virtual`` non-adjacent stage
              chunks (stage k and k+S, ...), shrinking the bubble to
              ~(S-1)/(v*M+S-1). Schedule-level support (compiled and
              validated here); the channel wiring for looped placements
              is future work — ``Pipeline`` rejects virtual > 1.

Each stage's parameter group composes with ZeRO-1 (train/zero.py): with
``replicas`` > 1 the same stage runs on several data-parallel actors,
microbatches round-robin across the replica chains, and at step end
each stage's replicas sync gradients through a per-stage
``ShardedOptimizer`` ring (reduce-scatter mean -> shard-local update ->
parameter allgather) — optimizer state is 1/replicas per actor.

Usage (driver side — a plain script or inside a train_fn)::

    Stage = ray_tpu_torch.remote(max_concurrency=2)(
        train.PipelineStageActor)
    s0 = Stage.remote(stage0_fn, params0, optimizer=sgd)
    s1 = Stage.remote(stage1_fn, params1, optimizer=sgd, is_last=True)
    pipe = train.Pipeline([s0, s1], num_microbatches=8)
    for step in range(steps):
        out = pipe.step(microbatches)       # len == num_microbatches
        print(out.loss, out.bubble_fraction)
    pipe.teardown()

(``max_concurrency=2`` lets ``save_checkpoint``/``restore_checkpoint``
reach a stage between steps: its pinned loop holds one executor thread
for the pipeline's life.)

The port's copy of ``ray_tpu/train/pipeline.py``. The schedule compiler,
the channel wiring and the driver are the reference's with import paths
changed. ``PipelineStageActor`` runs a torch ``stage_fn(params, x)`` on
its ``device`` (the card unless the caller asks for the CPU): the
forward under ``torch.no_grad()`` keeping only the input, the backward
a recompute of the forward with grad on, then ``torch.autograd.grad``
of the output against the incoming gradient (plain autograd: the flash
kernels' ``autograd.Function`` does not go through ``torch.func``
transforms). On the card a stage's attention is the hand-written
kernels: K1 without lse in each F op, K1 with lse, K2 and K3 in each B
op. The optimizer is anything optax-shaped (``init``/``update``
returning ``(updates, state)``) whose updates are added with tensor
ops, or ``ShardedOptimizer`` around one.

The schedule emits bubble accounting through the event plane:
``pipeline_bubble_s`` / ``pipeline_stage_step_s`` metrics plus
stage-tagged "pipeline" spans, rendered by the timeline as
``pipe:stage<k>`` lanes with forward-only microbatch flow edges, and
pulled into a ``TrainContext.trace_step()`` waterfall by group id (the
collective-rounds pattern)."""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.dag.ring import _map_leaves, _zip_leaves


def pipeline_metrics() -> dict:
    """Get-or-create the pipeline-plane series (process-global registry,
    head-aggregated like every other pushed metric).

      pipeline_stage_step_s   wall time of one schedule step on this
                              stage actor (all F/B ops + optimizer)
      pipeline_bubble_s       per step, the time this stage sat idle
                              waiting for a microbatch that was not
                              hidden under compute — the pipeline
                              bubble, measured not asserted
      pipeline_activation_bytes_total
                              payload bytes this stage shipped across
                              forward/backward channel edges
                              (device-ref mode counts the tensor bytes
                              the handle stands for)
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "stage_step": m.Histogram(
            "pipeline_stage_step_s",
            "Wall time of one pipeline schedule step on one stage "
            "actor: every forward/backward microbatch op plus the "
            "end-of-step optimizer update",
            tag_keys=("stage",)),
        "bubble": m.Histogram(
            "pipeline_bubble_s",
            "Per pipeline step, the recv-wait on this stage that was "
            "NOT hidden under microbatch compute — the measured "
            "bubble (fill/drain + straggler stalls); compare against "
            "the analytic (S-1)/(M+S-1) bound",
            tag_keys=("stage",)),
        "activation_bytes": m.Counter(
            "pipeline_activation_bytes_total",
            "Activation/gradient payload bytes shipped by this stage "
            "across pipeline channel edges (device-ref transport "
            "counts the referenced tensor bytes)"),
    }


# --- schedule compiler ---------------------------------------------------

SCHEDULES = ("gpipe", "1f1b", "interleaved")

# An op is ("F", mb) or ("B", mb) — with interleaved virtual stages,
# ("F", mb, chunk) / ("B", mb, chunk); the runtime treats the 2-tuples
# as chunk 0.


def compile_schedule(num_stages: int, num_microbatches: int,
                     kind: str = "1f1b", virtual: int = 1) -> List[list]:
    """Per-stage ordered op lists for one training step. Returns
    ``schedules[p]`` = the exact sequence stage p executes; every list
    is dependency-valid (``validate_schedule``) by construction.

    1F1B warmup depth at stage p is ``min(M, S-1-p)``: enough forwards
    in flight to keep downstream stages fed, never more — in-flight
    activations at stage p stay <= S-p (the O(stages) memory bound),
    vs GPipe's M."""
    S, M, v = int(num_stages), int(num_microbatches), int(virtual)
    if S < 1:
        raise ValueError(f"num_stages must be >= 1, got {S}")
    if M < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M}")
    if kind not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {kind!r}")
    if v < 1:
        raise ValueError(f"virtual must be >= 1, got {v}")
    if kind != "interleaved" and v != 1:
        raise ValueError("virtual stages need kind='interleaved'")
    if kind == "gpipe":
        return [[("F", i) for i in range(M)]
                + [("B", i) for i in reversed(range(M))]
                for _ in range(S)]
    if kind == "1f1b":
        out = []
        for p in range(S):
            warm = min(M, S - 1 - p)
            ops: list = [("F", i) for i in range(warm)]
            for i in range(M - warm):        # steady state: 1F then 1B
                ops.append(("F", warm + i))
                ops.append(("B", i))
            ops += [("B", i) for i in range(M - warm, M)]
            out.append(ops)
        return out
    # interleaved: worker w holds chunks (w, w+S, ..., w+(v-1)S) of a
    # v*S-deep virtual pipeline; microbatches cycle chunk-major in
    # groups of S so each worker touches every chunk per group
    # (Megatron-LM's interleaved 1F1B, simplified to full groups).
    depth = v * S
    fwd_order: List[List[tuple]] = [[] for _ in range(S)]
    for g in range(0, M, S):
        grp = list(range(g, min(g + S, M)))
        for c in range(v):
            for i in grp:
                for p in range(S):
                    fwd_order[p].append(("F", i, c))
    bwd_order: List[List[tuple]] = [[] for _ in range(S)]
    for g in range(0, M, S):
        grp = list(range(g, min(g + S, M)))
        for c in reversed(range(v)):
            for i in grp:
                for p in range(S):
                    bwd_order[p].append(("B", i, c))
    # fill/steady/drain interleave: warmup depth per worker mirrors the
    # flat 1F1B rule against the VIRTUAL depth
    out = []
    for p in range(S):
        warm = min(len(fwd_order[p]), depth - 1 - p)
        ops = list(fwd_order[p][:warm])
        f, b = warm, 0
        while f < len(fwd_order[p]):
            ops.append(fwd_order[p][f])
            ops.append(bwd_order[p][b])
            f += 1
            b += 1
        ops += bwd_order[p][b:]
        out.append(ops)
    return out


def _op_key(p: int, op: tuple) -> tuple:
    kind, mb = op[0], op[1]
    chunk = op[2] if len(op) > 2 else 0
    return (kind, mb, chunk, p)


def schedule_deps(schedules: List[list],
                  virtual: int = 1) -> Dict[tuple, List[tuple]]:
    """The dependency DAG a schedule must satisfy, keyed
    ``(kind, mb, chunk, stage) -> [prereq keys]``:

      - F(mb) at virtual depth d needs F(mb) at depth d-1 (the
        activation edge);
      - B(mb) at depth d needs B(mb) at depth d+1 (the gradient edge)
        and F(mb) at depth d (the stored residual/input);
      - ops on one stage worker are serial in list order.

    Unit tests run ``simulate`` over this to prove 1F1B never
    deadlocks and to count idle ticks."""
    S = len(schedules)
    depth = virtual * S

    def by_depth(d: int, kind: str, mb: int) -> tuple:
        return (kind, mb, d // S, d % S)

    deps: Dict[tuple, List[tuple]] = {}
    for p, ops in enumerate(schedules):
        prev = None
        for op in ops:
            kind, mb = op[0], op[1]
            chunk = op[2] if len(op) > 2 else 0
            d = chunk * S + p
            key = (kind, mb, chunk, p)
            pre: List[tuple] = []
            if prev is not None:
                pre.append(prev)
            if kind == "F" and d > 0:
                pre.append(by_depth(d - 1, "F", mb))
            if kind == "B":
                if d < depth - 1:
                    pre.append(by_depth(d + 1, "B", mb))
                pre.append((("F", mb, chunk, p)))
            deps[key] = pre
            prev = key
    return deps


def simulate(schedules: List[list], virtual: int = 1,
             op_ticks: float = 1.0) -> dict:
    """Run the schedule against its dependency DAG with unit-time ops:
    returns {"ticks": critical-path length, "idle": per-stage idle
    ticks, "bubble_fraction": mean idle / ticks, "in_flight": max
    concurrently-held forward activations per stage}. Raises on a
    deadlocked (dependency-violating) schedule — the schedule-order
    unit test in one call."""
    deps = schedule_deps(schedules, virtual)
    done: Dict[tuple, float] = {}
    ready_at = [0.0] * len(schedules)
    cursor = [0] * len(schedules)
    in_flight = [0] * len(schedules)
    max_in_flight = [0] * len(schedules)
    idle = [0.0] * len(schedules)
    total = sum(len(ops) for ops in schedules)
    while len(done) < total:
        progressed = False
        # smallest-finish-first: deterministic and deadlock-detecting
        for p, ops in enumerate(schedules):
            if cursor[p] >= len(ops):
                continue
            op = ops[cursor[p]]
            key = _op_key(p, op)
            pre = deps[key]
            if any(k not in done for k in pre):
                continue
            start = max([ready_at[p]] + [done[k] for k in pre])
            idle[p] += start - ready_at[p]
            done[key] = start + op_ticks
            ready_at[p] = start + op_ticks
            if op[0] == "F":
                in_flight[p] += 1
                max_in_flight[p] = max(max_in_flight[p], in_flight[p])
            else:
                in_flight[p] -= 1
            cursor[p] += 1
            progressed = True
        if not progressed:
            stuck = [(p, schedules[p][cursor[p]])
                     for p in range(len(schedules))
                     if cursor[p] < len(schedules[p])]
            raise RuntimeError(f"schedule deadlock: {stuck}")
    ticks = max(done.values())
    # trailing idle: a stage finished early still waits out the step
    for p in range(len(schedules)):
        idle[p] += ticks - ready_at[p]
    return {"ticks": ticks, "idle": idle,
            "bubble_fraction": sum(idle) / (ticks * len(schedules)),
            "in_flight": max_in_flight}


def bubble_fraction(num_stages: int, num_microbatches: int,
                    virtual: int = 1) -> float:
    """Analytic pipeline bubble for equal-cost F/B ops:
    (S-1)/(v*M + S-1) of every stage's step is fill/drain idle."""
    S, M, v = num_stages, num_microbatches, virtual
    return (S - 1) / float(v * M + S - 1)


def fill_drain_counts(ops: List[tuple]) -> Tuple[int, int]:
    """(#forwards before the first backward, #backwards after the last
    forward) — the fill and drain depths of one stage's op list."""
    first_b = next((j for j, op in enumerate(ops) if op[0] == "B"),
                   len(ops))
    last_f = max((j for j, op in enumerate(ops) if op[0] == "F"),
                 default=-1)
    return first_b, len(ops) - 1 - last_f if last_f >= 0 else 0


# --- the stage program ---------------------------------------------------


class PipelineStageActor:
    """A ready-made dag actor hosting ONE pipeline stage: a forward
    program, a recompute-backward program (the stage stores only each
    in-flight microbatch's INPUT and re-runs the forward with grad on
    inside the backward — rematerialization, so per-stage memory is
    O(in-flight inputs), which 1F1B bounds at S-p), gradient
    accumulation, and the end-of-step optimizer update.

    ``stage_fn(params, x) -> y`` is this stage's slice of the model in
    torch; ``params`` is a pytree (dict / list / tuple) of tensors or
    numpy arrays, moved to ``device`` here (None: the card, raising
    without one; tests pass ``"cpu"``), and every payload leaf is moved
    there before ``stage_fn`` sees it. The LAST stage's fn must return a
    scalar loss (its backward seeds with 1.0). ``optimizer`` is
    optax-shaped (``init(params)``, ``update(grads, state, params) ->
    (updates, state)``; the updates are added here with tensor ops);
    when the driver wires a per-stage ZeRO ring (``Pipeline(replicas=
    ...)`` or an explicit ``zero_spec``) the update runs through
    ``train.ShardedOptimizer`` over that ring — reduce-scatter mean
    grads across the stage's data-parallel replicas, shard-local
    moments, parameter allgather — otherwise plain (replicated).
    ``zero="local"`` forces the ShardedOptimizer code path at one
    replica (same numerics as sharded, degenerate full-width shard).

    Duck typing: any actor exposing ``pipe_forward(mb, payload)``,
    ``pipe_backward(mb, grad)``, ``pipe_step()`` (and optionally
    ``pipe_configure(spec)``) can be a pipeline stage — the runtime
    loop (dag/runtime.py pipe_exec_loop) only calls these."""

    def __init__(self, stage_fn: Callable, params: Any, *,
                 optimizer: Any = None, is_last: bool = False,
                 zero: Optional[str] = None,
                 zero_opts: Optional[dict] = None, device=None):
        from ray_tpu_torch._device import resolve_device
        if zero not in (None, "local"):
            raise ValueError(f"zero must be None or 'local', got {zero!r}")
        self._fn = stage_fn
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self._optax = optimizer
        self.is_last = bool(is_last)
        self._zero = zero
        self._zero_opts = dict(zero_opts or {})
        self._zero_spec: Optional[dict] = None
        self._ring = None
        self._opt = None            # resolved optimizer wrapper
        self._opt_state = None
        self._inputs: Dict[int, Any] = {}     # in-flight mb -> input
        self._losses: List[Any] = []
        self._acc = None
        self._acc_n = 0
        self.step_count = 0
        # pending optimizer-state restore (pipe_restore before the
        # first step resolved the per-stage ring): applied lazily the
        # moment _opt_state materializes
        self._restore_opt: Optional[dict] = None

    # -- wiring ----------------------------------------------------------

    def pipe_configure(self, spec: dict) -> None:
        """Called by the runtime loop before the first op: the driver's
        wiring rides in (per-stage ZeRO ring spec + ShardedOptimizer
        options, stage index)."""
        zs = spec.get("zero_spec")
        if zs is not None:
            zs = dict(zs)
            self._zero_opts.update(zs.pop("_opts", None) or {})
        self._zero_spec = zs
        self.stage = int(spec.get("stage", 0))

    def _resolve_opt(self):
        """The optimizer wrapper, resolved once: a ShardedOptimizer
        over the driver-wired per-stage ring (ZeRO-1 across this
        stage's data-parallel replicas), the degenerate local
        ShardedOptimizer (zero='local'), or the plain transformation."""
        if self._opt is not None or self._optax is None:
            return self._opt
        from ray_tpu_torch.train.zero import ShardedOptimizer
        if self._zero_spec is not None:
            from ray_tpu_torch.dag.ring import RingPeerDead, RingReducer
            from ray_tpu_torch.train.collective import peer_lost_error
            try:
                self._ring = RingReducer.from_spec(self._zero_spec)
            except RingPeerDead as e:
                raise peer_lost_error(e) from e
            self._opt = ShardedOptimizer(self._optax, group=self._ring,
                                         **self._zero_opts)
        elif self._zero == "local":
            self._opt = ShardedOptimizer(self._optax, **self._zero_opts)
        else:
            self._opt = self._optax         # plain replicated
        return self._opt

    # -- the three runtime entry points ----------------------------------

    def pipe_forward(self, mb: int, payload: Any):
        """One microbatch forward, grad off: returns the activation
        payload for the next stage (None at the last stage — the loss
        stays here until its B op). The input is retained until
        pipe_backward(mb) rematerializes through it."""
        import torch
        x = _to_device(payload, self.device)
        self._inputs[mb] = x
        with torch.no_grad():
            y = self._fn(self.params, x)
        if self.is_last:
            self._losses.append(y)
            return None
        return y

    def pipe_backward(self, mb: int, grad: Any):
        """One microbatch backward: recompute the forward with grad on
        over detached leaves, take ``torch.autograd.grad`` of the output
        against ``grad`` (1.0 at the last stage) over the parameters and
        the input's floating leaves, accumulate the parameter grads in
        the parameters' dtype, and return the input-activation gradient
        for the previous stage (None where an input leaf takes none)."""
        import torch
        x = self._inputs.pop(mb)
        leaves: list = []

        def grad_leaf(v):
            if _floating(v):
                v = v.detach().requires_grad_(True)
                leaves.append(v)
            return v
        params = _map_leaves(self.params, grad_leaf)
        n_params = len(leaves)
        xin = _map_leaves(x, grad_leaf)
        with torch.enable_grad():
            y = self._fn(params, xin)
            outs, seeds = [], []
            if self.is_last:
                outs, seeds = [y], [torch.ones_like(y)]
            else:
                grad = _to_device(grad, self.device)

                def pair(o, g):
                    if g is not None and _floating(o) and o.requires_grad:
                        outs.append(o)
                        seeds.append(g.to(o.dtype))
                _zip_leaves(y, grad, pair)
            got = torch.autograd.grad(outs, leaves, seeds,
                                      allow_unused=True) \
                if outs else [None] * len(leaves)
        del y, outs, seeds
        got = [torch.zeros_like(v) if g is None else g
               for g, v in zip(got, leaves)]
        it_p, it_x = iter(got[:n_params]), iter(got[n_params:])
        gparams = _map_leaves(
            self.params, lambda v: next(it_p) if _floating(v) else None)
        gx = _map_leaves(x, lambda v: next(it_x) if _floating(v) else None)
        self._acc = gparams if self._acc is None else \
            _tree_add(self._acc, gparams)
        self._acc_n += 1
        return gx

    def pipe_step(self) -> dict:
        """End of one schedule step: mean the accumulated grads over
        this actor's microbatches and update parameters — through the
        per-stage ZeRO ring when one is wired (reduce-scatter mean
        makes the result the GLOBAL microbatch mean across replicas).
        Returns {"loss": ..., "mb": n} for the driver."""
        import torch
        out: dict = {"mb": self._acc_n}
        if self._losses:
            out["loss"] = float(np.mean(np.asarray(
                [float(v) for v in self._losses], np.float32)))
        if self._acc is not None and self._optax is not None:
            grads = _tree_scale(self._acc, 1.0 / max(1, self._acc_n))
            opt = self._resolve_opt()
            from ray_tpu_torch.train.zero import ShardedOptimizer
            with torch.no_grad():
                if isinstance(opt, ShardedOptimizer):
                    if self._opt_state is None:
                        self._opt_state = opt.init(self.params)
                        self._apply_opt_restore()
                    self.params, self._opt_state = opt.update(
                        grads, self._opt_state, self.params)
                else:
                    if self._opt_state is None:
                        self._opt_state = opt.init(self.params)
                    updates, self._opt_state = opt.update(
                        grads, self._opt_state, self.params)
                    self.params = _apply_updates(self.params, updates)
            del grads
        if self._inputs:
            leaked = sorted(self._inputs)
            self._inputs.clear()
            raise RuntimeError(
                f"schedule ended with un-backpropagated microbatches "
                f"{leaked} still in flight — F/B counts don't match")
        self._losses = []
        self._acc = None
        self._acc_n = 0
        self.step_count += 1
        return out

    # -- checkpointing (train/ckptio.py pipeline spaces) -----------------

    def pipe_snapshot(self, rank: Optional[int] = None,
                      world: Optional[int] = None,
                      full_params: bool = True) -> dict:
        """One replica's checkpoint shard of THIS stage: the stage
        params flattened (stage params exist nowhere else — a lost
        stage is unrecoverable without this), this replica's
        ZeRO-shard elementwise optimizer leaves + bounds under the
        per-stage ring's split, and the step counter. Host numpy
        throughout (the blob crosses the object plane); the flat
        parameters are in the wire dtype of their leaves (a bf16 leaf
        as float32, exactly).

        With ``full_params=False`` (replicas j>0 of a driver-side
        save — replicas are bitwise identical, so one full copy
        suffices) the blob carries only this replica's owned
        ``param_seg`` + ``bounds`` under the per-stage split
        (optimizer bounds when the ring resolved them, else
        ``shard_bounds(total, world, rank)``) — an R-replica stage
        then ships ~1 full copy instead of R."""
        from ray_tpu_torch.dag.ring import (_flatten, _numel, stage_leaf,
                                            to_host)
        from ray_tpu_torch.train.collective import _raw_leaves
        from ray_tpu_torch.train.zero import ShardedOptimizer
        leaves = _raw_leaves(self.params)
        total = int(sum(_numel(l) for l in leaves))
        wire = ShardedOptimizer._wire_of(leaves)
        flat = np.empty(total, wire)
        off = 0
        for l in leaves:
            n = _numel(l)
            flat[off:off + n] = stage_leaf(l).reshape(-1)
            off += n
        out = {"total": total, "step_count": int(self.step_count),
               "layout": [(tuple(l.shape), _numel(l), str(l.dtype))
                          for l in leaves]}
        opt = self._opt
        bounds = None
        if self._opt_state is not None and \
                isinstance(opt, ShardedOptimizer) and \
                opt._bounds is not None:
            lo, hi = opt._bounds
            bounds = (int(lo), int(hi))
            sleaves, _, _ = _flatten(to_host(self._opt_state)[0])
            elem, other = [], []
            for a in sleaves:
                if a.ndim >= 1 and a.size == hi - lo:
                    elem.append(np.array(a.reshape(-1), copy=True))
                else:
                    other.append(np.array(a, copy=True))
            out["opt"] = {"bounds": bounds,
                          "elem": elem, "other": other}
        if full_params:
            out["params_flat"] = flat
        else:
            if bounds is None:
                from ray_tpu_torch.train.reshard import shard_bounds
                bounds = shard_bounds(total, int(world), int(rank))
            out["bounds"] = bounds
            out["param_seg"] = np.ascontiguousarray(
                flat[bounds[0]:bounds[1]])
        return out

    def pipe_restore(self, blob: dict) -> bool:
        """Load a ``pipe_snapshot``-shaped blob back into this stage:
        params always (each leaf back in its dtype on its device);
        optimizer state when the blob carries a shard and this
        replica's CURRENT bounds can be re-sliced from it (the caller
        pre-reslices across replica counts via train/ckptio.py — see
        Pipeline.restore_checkpoint)."""
        from ray_tpu_torch.dag.ring import _numel, unflat
        from ray_tpu_torch.train.collective import _raw_leaves
        flat = np.asarray(blob["params_flat"]).reshape(-1)
        have = int(sum(_numel(l) for l in _raw_leaves(self.params)))
        if have != flat.size:
            raise ValueError(
                f"stage checkpoint has {flat.size} params, stage "
                f"has {have}")
        self.params = unflat(flat, self.params)
        self.step_count = int(blob.get("step_count", 0))
        opt_blob = blob.get("opt")
        if opt_blob is not None:
            # stash for lazy application: the optimizer (and its
            # state template) may not be resolved until the first
            # pipe_step touches the per-stage ring
            self._restore_opt = dict(opt_blob)
            self._apply_opt_restore()
        return True

    def _apply_opt_restore(self) -> None:
        if getattr(self, "_restore_opt", None) is None or \
                self._opt_state is None:
            return
        from ray_tpu_torch.train.ckptio import _rebuild_state
        from ray_tpu_torch.train.zero import ShardedOptimizer
        opt = self._opt
        if not isinstance(opt, ShardedOptimizer) or \
                opt._bounds is None:
            return
        blob, self._restore_opt = self._restore_opt, None
        lo, hi = opt._bounds
        blo, bhi = blob["bounds"]
        if (int(blo), int(bhi)) != (int(lo), int(hi)):
            # the caller should have re-sliced (ckptio.reslice_
            # segments) before shipping; mismatched bounds here mean
            # it didn't — params are restored, moments start fresh
            print(f"[pipeline] stage opt restore skipped: blob "
                  f"bounds {(blo, bhi)} != ring bounds {(lo, hi)}")
            return
        from ray_tpu_torch.dag.ring import to_host
        self._opt_state = _rebuild_state(
            to_host(self._opt_state)[0], hi - lo, list(blob["elem"]),
            list(blob["other"]))

    # -- test/debug surface ----------------------------------------------

    def get_params(self):
        return self.params

    def pipe_close(self) -> bool:
        if self._ring is not None:
            try:
                self._ring.close()
            except Exception:   # noqa: BLE001 — teardown
                pass
            self._ring = None
        return True


def _floating(v) -> bool:
    import torch
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _to_device(tree, device):
    """Every tensor or numpy leaf of ``tree`` as a tensor on ``device``
    (numpy arrays through ``torch.from_numpy``, dtype kept); other
    leaves as they are."""
    import torch

    def put(v):
        if isinstance(v, np.ndarray):
            if not v.flags.writeable:
                v = v.copy()
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return v
    return _map_leaves(tree, put)


def _tree_add(a, b):
    return _zip_leaves(a, b, lambda x, y: x if y is None else
                       (y if x is None else x + y))


def _tree_scale(a, s: float):
    return _map_leaves(a, lambda x: None if x is None else x * s)


def _apply_updates(params, updates):
    """optax.apply_updates on tensors: ``p + u`` in ``p``'s dtype."""
    return _zip_leaves(params, updates,
                       lambda p, u: p if u is None else (p + u).to(p.dtype))


# --- channel wiring -------------------------------------------------------


def build_pipe_specs(num_stages: int, schedules: List[list], *,
                     replicas: int = 1,
                     edge: Callable[[Tuple[int, int], Tuple[int, int]],
                                    dict],
                     driver_edge: Callable[[Tuple[int, int], bool], dict],
                     zero_edge: Optional[Callable[[int, int], dict]] = None,
                     group: str = "", device: bool = False,
                     ttl_s: Optional[float] = None,
                     timeout_s: float = 300.0,
                     step_base: int = 0) -> List[List[dict]]:
    """Per-(stage, chain) runtime specs for ``pipe_exec_loop``, with
    the channel-spec construction delegated so one function serves the
    cluster driver (placement-aware shm/TCP edges), in-process tests
    (eager shm), and the multi-process bench.

    ``edge((p, j), (q, j))`` -> channel spec for the chain-j edge
    between stages p and q (called once per direction);
    ``driver_edge((p, j), is_input)`` -> spec for driver <-> stage
    endpoints (the chain input feed and each actor's result channel);
    ``zero_edge(k, j)`` -> spec for stage k's ZeRO ring edge replica
    j -> j+1 (only called when replicas > 1)."""
    S, D = int(num_stages), int(replicas)
    # one channel per logical edge: producer's out-spec and consumer's
    # in-spec must name the SAME channel, so the factory is memoized
    # on the directed (src, dst) pair
    edge_cache: Dict[tuple, dict] = {}
    raw_edge = edge

    def edge(src, dst):
        key = (tuple(src), tuple(dst))
        if key not in edge_cache:
            edge_cache[key] = raw_edge(src, dst)
        return edge_cache[key]

    specs: List[List[dict]] = []
    zero_rings: List[Optional[list]] = []
    for k in range(S):
        if D > 1 and zero_edge is not None:
            edges = [zero_edge(k, j) for j in range(D)]
            zero_rings.append(edges)
        else:
            zero_rings.append(None)
    for k in range(S):
        row = []
        for j in range(D):
            fwd_in = (driver_edge((k, j), True) if k == 0
                      else edge((k - 1, j), (k, j)))
            fwd_out = None if k == S - 1 else edge((k, j), (k + 1, j))
            bwd_in = None if k == S - 1 else edge((k + 1, j), (k, j))
            bwd_out = None if k == 0 else edge((k, j), (k - 1, j))
            zspec = None
            if zero_rings[k] is not None:
                edges = zero_rings[k]
                zspec = {"rank": j, "size": D, "op": "mean",
                         "timeout_s": float(timeout_s), "own": j,
                         "group": f"{group}.z{k}",
                         "to_next": edges[j],
                         "from_prev": edges[(j - 1) % D]}
            row.append({
                "stage": k, "num_stages": S, "chain": j,
                "schedule": [list(op) for op in schedules[k]],
                "fwd_in": fwd_in, "fwd_out": fwd_out,
                "bwd_in": bwd_in, "bwd_out": bwd_out,
                "res_out": driver_edge((k, j), False),
                "zero_spec": zspec,
                "device": bool(device), "ttl_s": ttl_s,
                "group": group, "timeout_s": float(timeout_s),
                "step_base": int(step_base),
            })
        specs.append(row)
    return specs


def wire_local(num_stages: int, num_microbatches: int, *,
               schedule: str = "1f1b", replicas: int = 1,
               nslots: int = 8, slot_bytes: int = 4 << 20,
               device: bool = False, ttl_s: Optional[float] = None,
               timeout_s: float = 60.0, group: str = ""):
    """Wire a single-host pipeline with eager driver-created shm
    channels — the harness tests and the multi-process bench share
    this instead of each hand-rolling specs. Returns ``(specs,
    input_chans, res_chans, channels)``: feed chain j's microbatches
    into ``input_chans[j]``, read per-actor step reports from
    ``res_chans[k][j]``, and close+unlink every channel in
    ``channels`` when done."""
    from ray_tpu_torch.dag.channel import ShmRingChannel
    gid = group or uuid.uuid4().hex[:12]
    if num_microbatches % max(1, replicas):
        # same contract as Pipeline.__init__: a remainder microbatch
        # would sit in a chain's input ring and silently become the
        # NEXT step's first payload, skewing every later step
        raise ValueError(
            f"num_microbatches ({num_microbatches}) must divide "
            f"evenly across {replicas} replica chains")
    M_chain = num_microbatches // max(1, replicas)
    schedules = compile_schedule(num_stages, M_chain, schedule)
    channels: list = []
    input_chans: list = []
    res_chans: List[list] = [[] for _ in range(num_stages)]

    def shm():
        ch = ShmRingChannel(create=True, nslots=nslots,
                            slot_bytes=slot_bytes)
        channels.append(ch)
        return ch

    def edge(src, dst):
        return shm().spec()

    def driver_edge(pos, is_input):
        ch = shm()
        k, j = pos
        if is_input:
            input_chans.append(ch)
        else:
            res_chans[k].append(ch)
        return ch.spec()

    def zero_edge(k, j):
        return shm().spec()

    specs = build_pipe_specs(
        num_stages, schedules, replicas=replicas, edge=edge,
        driver_edge=driver_edge, zero_edge=zero_edge, group=gid,
        device=device, ttl_s=ttl_s, timeout_s=timeout_s)
    return specs, input_chans, res_chans, channels


def pipeline_defaults() -> dict:
    """The ``pipeline_*`` Config knobs as a resolved dict — the ONE
    place ``Pipeline`` reads its defaults from (and the unit-testable
    surface for the knob family without standing up a cluster)."""
    from ray_tpu_torch.config import get_config
    cfg = get_config()
    return {
        "schedule": getattr(cfg, "pipeline_schedule", "1f1b"),
        "device": bool(getattr(cfg, "pipeline_device_transport", True)),
        "ttl_s": float(getattr(cfg, "pipeline_activation_ttl_s", 600.0)),
        "timeout_s": float(getattr(cfg, "pipeline_step_timeout_s",
                                   300.0)),
    }


# --- driver ---------------------------------------------------------------


class PipelineStepResult:
    """One pipeline step as the driver sees it: ``loss`` (mean over
    last-stage replicas), per-actor ``reports`` (stage, chain, stats),
    and the measured ``bubble_fraction`` (max over stages of
    bubble_s / step_s — the slowest stage's idle share)."""

    def __init__(self, loss: Optional[float], reports: List[dict]):
        self.loss = loss
        self.reports = reports
        fracs = [r["stats"]["bubble_s"] / r["stats"]["step_s"]
                 for r in reports
                 if r.get("stats") and r["stats"].get("step_s")]
        self.bubble_fraction = max(fracs) if fracs else 0.0

    def __repr__(self):
        return (f"PipelineStepResult(loss={self.loss}, "
                f"bubble_fraction={self.bubble_fraction:.3f})")


class Pipeline:
    """Driver handle for a wired pipeline over dag actors.

    ``stages`` is a list of actor handles — one per stage — or a list
    of equal-length replica lists for pipeline + data-parallel:
    microbatches round-robin across the replica CHAINS, and at step
    end each stage's replicas ALWAYS sync through a per-stage ZeRO-1
    ring (ShardedOptimizer over the stage's replica pair — without
    the sync the chains would silently train divergent copies).
    ``zero_opts`` customizes that ShardedOptimizer (param_wire_dtype,
    grad_quantize, ...) and therefore requires replicas > 1; a
    single-replica stage wanting the ZeRO code path constructs its
    ``PipelineStageActor`` with ``zero="local"`` instead.

    Channel placement follows the dag compiler's rule: co-located
    endpoints get shm rings (driver-owned eager, or consumer-created
    lazy), cross-node edges get TCP. Defaults for ``schedule``,
    ``device`` (TensorRef transport), activation TTL and the step
    timeout come from the ``pipeline_*`` Config knobs."""

    def __init__(self, stages: Sequence, *, num_microbatches: int,
                 schedule: Optional[str] = None,
                 device: Optional[bool] = None,
                 nslots: int = 8, slot_bytes: int = 4 << 20,
                 timeout_s: Optional[float] = None,
                 zero_opts: Optional[dict] = None,
                 virtual: int = 1):
        if virtual != 1:
            raise NotImplementedError(
                "interleaved virtual stages are schedule-level only "
                "for now (compile_schedule supports them; the looped "
                "channel wiring does not)")
        knobs = pipeline_defaults()
        self.schedule_kind = schedule or knobs["schedule"]
        self.device = knobs["device"] if device is None else device
        self.timeout_s = knobs["timeout_s"] if timeout_s is None \
            else float(timeout_s)
        self.ttl_s = knobs["ttl_s"]
        rows = [list(s) if isinstance(s, (list, tuple)) else [s]
                for s in stages]
        D = len(rows[0])
        if any(len(r) != D for r in rows):
            raise ValueError("every stage needs the same replica count")
        if zero_opts is not None and D == 1:
            raise ValueError(
                "zero_opts configures the per-stage ZeRO ring across a "
                "stage's replica chains and needs replicas > 1 — for a "
                "single-replica stage construct PipelineStageActor "
                "with zero='local' instead")
        self.num_stages, self.replicas = len(rows), D
        self._actors = rows
        if num_microbatches % D:
            raise ValueError(
                f"num_microbatches ({num_microbatches}) must divide "
                f"evenly across {D} replica chains")
        self.num_microbatches = int(num_microbatches)
        self._m_chain = self.num_microbatches // D
        self.group = uuid.uuid4().hex[:12]
        self._nslots, self._slot_bytes = int(nslots), int(slot_bytes)
        self._zero_opts = zero_opts
        self._channels: list = []
        self._input_chans: list = []        # one per chain
        self._res_chans: List[list] = [[] for _ in rows]
        self._loops: list = []
        self._broken: Optional[BaseException] = None
        self._torn_down = False
        self.stage_stats: Optional[list] = None
        self._steps = 0
        self._ctx = self._train_context()
        step_base = 0
        if self._ctx is not None:
            self._ctx.register_pipeline(self.group)
            # stage spans tag the pipeline's OWN step counter (not
            # collective_step — an auxiliary allreduce between pipe
            # steps must not desync the tags trace_step matches on)
            step_base = int(getattr(self._ctx, "pipeline_step", 0))
        self._wire(step_base)
        self._start()

    @staticmethod
    def _train_context():
        from ray_tpu_torch.train.api import get_context
        try:
            return get_context()
        except RuntimeError:
            return None         # plain script: no train context to tag

    # -- wiring -----------------------------------------------------------

    def _placements(self) -> List[List[str]]:
        """Cluster node id per (stage, chain) actor, same handshake as
        CompiledDag._validate (wait alive, then read placement)."""
        from ray_tpu_torch.api import _require_init, _run
        ctx = _require_init()
        self._driver_node = ctx.node_id
        # one pinned loop per actor (the compiled-dag rule): a reused
        # handle's second loop would never start and the first step()
        # would stall to the full timeout instead of failing fast
        seen = set()
        for row in self._actors:
            for h in row:
                if h._actor_id in seen:
                    raise ValueError(
                        "pipelines pin one exec loop per actor — use "
                        "a distinct actor for each stage/replica")
                seen.add(h._actor_id)
        out = []
        for row in self._actors:
            prow = []
            for h in row:
                aid = h._actor_id
                _run(ctx.pool.call(ctx.head_addr, "wait_actor_alive",
                                   actor_id=aid, wait_timeout=60.0))
                info = _run(ctx.pool.call(ctx.head_addr, "get_actor",
                                          actor_id=aid))
                prow.append((info or {}).get("node_id") or ctx.node_id)
            out.append(prow)
        return out

    def _wire(self, step_base: int) -> None:
        from ray_tpu_torch.dag.channel import ShmRingChannel, new_tcp_spec
        placement = self._placements()

        def shm_eager():
            ch = ShmRingChannel(create=True, nslots=self._nslots,
                                slot_bytes=self._slot_bytes)
            self._channels.append(ch)
            return ch

        def lazy_shm(tag: str) -> dict:
            return {"name": f"rtpp-{self.group}-{tag}",
                    "nslots": self._nslots,
                    "slot_bytes": self._slot_bytes, "lazy": True}

        edge_n = [0]

        def edge(src, dst):
            p, j = src
            q, _ = dst
            edge_n[0] += 1
            if placement[p][j] == placement[q][j]:
                return lazy_shm(f"e{edge_n[0]}")
            return new_tcp_spec(self._nslots, self._slot_bytes)

        def driver_edge(pos, is_input):
            k, j = pos
            if placement[k][j] == self._driver_node:
                ch = shm_eager()
                if is_input:
                    self._input_chans.append(ch)
                else:
                    self._res_chans[k].append(ch)
                return ch.spec()
            from ray_tpu_torch.dag.channel import TcpChannel
            spec = new_tcp_spec(self._nslots, self._slot_bytes)
            role = "producer" if is_input else "consumer"
            ch = TcpChannel(spec, role)
            self._channels.append(ch)
            if is_input:
                self._input_chans.append(ch)
            else:
                self._res_chans[k].append(ch)
            return spec

        def zero_edge(k, j):
            edge_n[0] += 1
            if placement[k][j] == placement[k][(j + 1) % self.replicas]:
                return lazy_shm(f"z{k}-{j}")
            return new_tcp_spec(self._nslots, self._slot_bytes)

        schedules = compile_schedule(self.num_stages, self._m_chain,
                                     self.schedule_kind)
        self._specs = build_pipe_specs(
            self.num_stages, schedules, replicas=self.replicas,
            edge=edge, driver_edge=driver_edge,
            zero_edge=zero_edge if self.replicas > 1 else None,
            group=self.group, device=self.device, ttl_s=self.ttl_s,
            timeout_s=self.timeout_s, step_base=step_base)
        if self._zero_opts:
            for row in self._specs:
                for s in row:
                    if s["zero_spec"] is not None:
                        s["zero_spec"]["_opts"] = dict(self._zero_opts)

    def _start(self) -> None:
        from ray_tpu_torch.api import ActorMethod
        for k, row in enumerate(self._actors):
            for j, h in enumerate(row):
                # retries pinned to 0, like the compiled dag's loops: a
                # replayed loop would double-attach SPSC channels
                m = ActorMethod(h, "__pipe_exec_loop__",
                                max_task_retries=0)
                self._loops.append(m.remote(self._specs[k][j]))

    # -- stepping ---------------------------------------------------------

    def step(self, microbatches: Sequence,
             timeout: Optional[float] = None) -> PipelineStepResult:
        """Run ONE schedule step: feed ``num_microbatches`` payloads
        (chain j takes ``microbatches[j::replicas]``), wait for every
        stage actor's step report, and return the aggregated result.
        A dead stage or channel surfaces as ``train.PeerLostError``
        carrying the stage-side flight-recorder path when one was
        dumped; any user-code error re-raises as itself.

        The default driver-side bound is 4x the step timeout, NOT the
        step timeout itself: a stage dead mid-step is detected by its
        NEIGHBORS' bounded channel waits within ~timeout_s and their
        PeerLostError reports reach the driver promptly, so the
        driver's own deadline only backstops total failure — it must
        ride out compile-heavy first steps and long compute that the
        mid-step knob deliberately doesn't bound. Pass ``timeout``
        for a tighter per-call bound."""
        from ray_tpu_torch.runtime.serialization import serialize
        if self._torn_down:
            raise RuntimeError("pipeline torn down")
        if self._broken is not None:
            raise RuntimeError(
                "pipeline is broken by an earlier failure; tear it "
                "down and rebuild") from self._broken
        if len(microbatches) != self.num_microbatches:
            raise ValueError(
                f"expected {self.num_microbatches} microbatches, "
                f"got {len(microbatches)}")
        from ray_tpu_torch.dag.channel import ChannelClosed, ChannelTimeout
        from ray_tpu_torch.train.collective import PeerLostError
        deadline = time.monotonic() + (
            4 * self.timeout_s if timeout is None else float(timeout))
        for j, ch in enumerate(self._input_chans):
            for mb in microbatches[j::self.replicas]:
                try:
                    ch.write(serialize(mb), timeout=max(
                        0.1, deadline - time.monotonic()))
                except (ChannelTimeout, ChannelClosed) as e:
                    # a full-forever/closed input ring means stage 0
                    # stopped consuming — same terminal contract as a
                    # mid-step stage death
                    err = PeerLostError(
                        f"pipeline input edge (chain {j}) not "
                        f"accepting microbatches: {e}")
                    self._broken = err
                    raise err from e
        reports = self._collect_reports(deadline)
        try:
            # the slowest stage's idle this step (the same max the
            # bubble_fraction property takes) — attributed into the
            # driver's open goodput step window as `bubble`, so a
            # pipeline-bound step's anatomy names the schedule, not
            # an opaque residual
            from ray_tpu_torch.util import goodput
            goodput.add("bubble", max(
                (float(r["stats"]["bubble_s"]) for r in reports
                 if r.get("stats")), default=0.0))
        except Exception:   # noqa: BLE001
            pass
        loss_vals = [r["result"]["loss"] for r in reports
                     if r["stage"] == self.num_stages - 1
                     and r["result"].get("loss") is not None]
        loss = (sum(loss_vals) / len(loss_vals)) if loss_vals else None
        self._steps += 1
        if self._ctx is not None:
            # trace_step reads this counter to tag which pipeline
            # step ran inside its span (the pstep tag)
            self._ctx.pipeline_step = getattr(
                self._ctx, "pipeline_step", 0) + 1
        return PipelineStepResult(loss, reports)

    # -- durable checkpointing (train/ckptio.py) --------------------------

    def save_checkpoint(self, storage_path: str,
                        step: Optional[int] = None, *,
                        metrics: Optional[dict] = None) -> str:
        """Synchronous driver-side sharded save of the whole pipeline
        between steps: ONE ckptio manifest with a space per stage
        (``stage<k>``) — each replica chain contributes its ZeRO
        optimizer shard, replica 0's snapshot supplies the stage's
        full parameters (replicas are bitwise identical). The same
        two-phase commit as the data-parallel plane: shard files +
        hashes first, the manifest marker last, so a driver crash
        mid-save leaves the previous checkpoint resolving. Restore
        re-slices per stage, so a different replica count on resume
        follows the same path as the ZeRO N'≠N restore."""
        import ray_tpu_torch
        from ray_tpu_torch.train import ckptio
        from ray_tpu_torch.train.reshard import shard_bounds
        if step is None:
            step = self._steps
        ckpt = ckptio.ckpt_dirname(step)
        spaces: Dict[str, dict] = {}
        for k, row in enumerate(self._actors):
            # replica 0 ships the full stage params (replicas are
            # bitwise identical — one copy suffices); j>0 ship only
            # their owned segment + their optimizer shard, so an
            # R-replica stage moves ~1 full copy, not R
            blobs = ray_tpu_torch.get(
                [h.pipe_snapshot.remote(rank=j, world=len(row),
                                        full_params=(j == 0))
                 for j, h in enumerate(row)], timeout=120)
            metas = []
            for j, blob in enumerate(blobs):
                total = int(blob["total"])
                opt = blob.get("opt")
                if opt is not None:
                    lo, hi = (int(b) for b in opt["bounds"])
                    elem, other = opt["elem"], opt["other"]
                else:
                    lo, hi = (int(b) for b in blob["bounds"]) \
                        if "bounds" in blob \
                        else shard_bounds(total, len(row), j)
                    elem, other = [], []
                if "param_seg" in blob:
                    seg = np.asarray(blob["param_seg"]).reshape(-1)
                else:
                    seg = np.ascontiguousarray(np.asarray(
                        blob["params_flat"]).reshape(-1)[lo:hi])
                arrays = {"param_seg": seg}
                for e, a in enumerate(elem):
                    arrays[f"elem_{e}"] = a
                for o, a in enumerate(other):
                    arrays[f"other_{o}"] = a
                arrays["_counts"] = np.array(
                    [len(elem), len(other)], np.int64)
                metas.append(ckptio.write_shard(
                    storage_path, ckpt, space=f"stage{k}", rank=j,
                    world=len(row), bounds=(lo, hi), total=total,
                    arrays=arrays, step=step))
            spaces[f"stage{k}"] = {"shards": metas}
        ckptio.commit_manifest(
            storage_path, ckpt, step=step, spaces=spaces,
            group={"kind": "pipeline", "stages": self.num_stages,
                   "replicas": self.replicas, "group_id": self.group},
            user_meta={"metrics": dict(metrics or {})})
        return f"{storage_path.rstrip('/')}/{ckpt}"

    def restore_checkpoint(self, path: str) -> int:
        """Load a ``save_checkpoint`` manifest back into the wired
        stage actors, re-slicing each stage's optimizer shards to the
        CURRENT replica count (``ckptio.reslice_segments`` — the same
        re-slice the data-parallel restore uses). Returns the
        restored step."""
        import ray_tpu_torch
        from ray_tpu_torch.train import ckptio
        from ray_tpu_torch.train.reshard import shard_bounds
        man = ckptio.manifest_of(path)
        if man is None:
            raise ckptio.CkptError(
                f"{path} has no committed manifest")
        from ray_tpu_torch.util import storage as _st
        st, root = _st.get_storage(path)
        refs = []
        for k, row in enumerate(self._actors):
            sp = man["spaces"].get(f"stage{k}")
            if sp is None:
                raise ckptio.CkptError(
                    f"checkpoint {path} has no space stage{k} "
                    f"(pipeline shape changed?)")
            total = int(sp["total"])
            from ray_tpu_torch.config import get_config
            verify = bool(getattr(get_config(), "ckpt_verify_hash",
                                  True))
            try:
                # shared assembly protocol (load + hash verify +
                # consistency + coverage) — one implementation for
                # the ZeRO restore and the per-stage restore, so the
                # validation can't drift between them
                full, elem_pieces, others = ckptio._assemble_space(
                    st, root, sp, verify)
            except ckptio.CkptError as e:
                raise ckptio.CkptError(f"stage{k}: {e}") from e
            for j, h in enumerate(row):
                nlo, nhi = shard_bounds(total, len(row), j)
                blob = {"total": total, "params_flat": full,
                        "step_count": int(man["step"])}
                if elem_pieces:
                    blob["opt"] = {
                        "bounds": (nlo, nhi),
                        "elem": [ckptio.reslice_segments(
                            total, pieces, nlo, nhi,
                            pieces[0][2].dtype if pieces
                            else full.dtype)
                            for pieces in elem_pieces],
                        "other": list(others or [])}
                refs.append(h.pipe_restore.remote(blob))
        ray_tpu_torch.get(refs, timeout=120)
        return int(man["step"])

    def _collect_reports(self, deadline: float) -> List[dict]:
        from ray_tpu_torch.dag.channel import (DATA, ERROR, STOP,
                                         ChannelClosed, ChannelTimeout)
        from ray_tpu_torch.runtime.serialization import loads_oob
        from ray_tpu_torch.train.collective import PeerLostError
        reports = []
        for k, row in enumerate(self._res_chans):
            for j, ch in enumerate(row):
                try:
                    kind, payload = ch.read_bytes(
                        max(0.1, deadline - time.monotonic()))
                except (ChannelTimeout, ChannelClosed) as e:
                    err = PeerLostError(
                        f"pipeline stage {k} (chain {j}) stopped "
                        f"responding mid-step: {e}")
                    self._broken = err
                    raise err from e
                if kind == STOP:
                    err = PeerLostError(
                        f"pipeline stage {k} (chain {j}) exited "
                        f"mid-step")
                    self._broken = err
                    raise err
                if kind == ERROR:
                    err = loads_oob(payload)
                    if not isinstance(err, BaseException):
                        err = RuntimeError(str(err))
                    self._broken = err
                    raise err
                rep = loads_oob(payload)
                reports.append({"stage": k, "chain": j, **rep})
        return reports

    # -- teardown ---------------------------------------------------------

    def teardown(self, timeout: float = 30.0) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        if self._ctx is not None:
            # hand elastic reshape back to the worker group: the gate
            # must not outlive the pipeline it protects
            self._ctx.unregister_pipeline(self.group)
        from ray_tpu_torch import api
        from ray_tpu_torch.dag.channel import (STOP, ChannelClosed,
                                         ChannelTimeout)
        deadline = time.monotonic() + timeout
        for ch in self._input_chans:
            try:
                ch.write(b"", STOP, timeout=max(
                    0.1, deadline - time.monotonic()))
            except (ChannelTimeout, ChannelClosed):
                pass
        # drain result channels until their STOPs flow out, so stage
        # loops blocked writing a report can always finish
        for row in self._res_chans:
            for ch in row:
                try:
                    while time.monotonic() < deadline:
                        kind, _ = ch.read_bytes(0.5)
                        if kind == STOP:
                            break
                except (ChannelTimeout, ChannelClosed):
                    pass
        try:
            self.stage_stats = api.get(
                self._loops,
                timeout=max(2.0, (deadline - time.monotonic()) / 2))
        except Exception:   # noqa: BLE001 — a dead stage still tears down
            pass
        if self.stage_stats is None:
            # a DEAD stage cannot relay STOP down the chain, so
            # survivors sit parked at their step-boundary recv (shm
            # edges carry no peer-death signal) — inject STOP on the
            # in-edges whose PRODUCER loop is confirmed finished/dead.
            # The SPSC ring tolerates us as a second producer only
            # because the legitimate one is gone; edges with a live
            # (possibly mid-write) producer are left alone and unwind
            # through their own bounded channel timeouts.
            from ray_tpu_torch.dag.channel import attach_channel

            def loop_finished(k: int, j: int) -> bool:
                f = self._loops[k * self.replicas + j]
                try:
                    api.get([f], timeout=0.1)
                    return True
                except api.GetTimeoutError:
                    return False        # still running: live producer
                except Exception:   # noqa: BLE001 — died: producer gone
                    return True

            for k, row in enumerate(self._specs):
                for j, s in enumerate(row):
                    for key, prod in (("fwd_in", k - 1), ("bwd_in",
                                                          k + 1)):
                        spec = s.get(key)
                        if not spec or not 0 <= prod < self.num_stages:
                            continue    # driver edge / pipeline end
                        if not loop_finished(prod, j):
                            continue
                        try:
                            ch = attach_channel(spec, "producer",
                                                timeout=2.0)
                            ch.write(b"", STOP, timeout=1.0)
                            ch.close()
                        except Exception:   # noqa: BLE001 — best effort
                            pass
            try:
                self.stage_stats = api.get(
                    self._loops,
                    timeout=max(1.0, deadline - time.monotonic()))
            except Exception:   # noqa: BLE001
                pass
        for ch in self._channels:
            ch.close()
            try:
                ch.unlink()
            except Exception:   # noqa: BLE001
                pass

    def __del__(self):
        try:
            self.teardown(timeout=1.0)
        except Exception:   # noqa: BLE001
            pass
