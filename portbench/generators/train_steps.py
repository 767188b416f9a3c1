"""Training steps through the port's ``make_train_step``.

Set-up builds one train state (the port's model on weights drawn from
the seed, its optimizer) and drives it through the traffic's first
``checked_steps`` steps, the reference's, with the window's own call and
feed; they are also the warm-up. The window then runs more steps, each
on a fresh batch and each ending in the host's read of its loss, until
``--seconds`` have passed: tokens trained over the window's time. With
``--trace 1``, ``trace_steps`` more steps run under the profiler. Then
the program's state is freed and the reference follows the first steps.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.bench import model as bm
from portbench.bench import trace as tr_mod

OPT_RANGE = "portbench.optimizer"
# the optimizer keywords the port's default_optimizer takes
OPT_KEYS = ("learning_rate", "weight_decay", "warmup_steps", "total_steps",
            "grad_clip")
# leaves whose first gradient in the reference is under this share of the
# median leaf's move by round-off alone: left out of the change
MOVED_SHARE = 1e-3


class RangedOptimizer:
    """The step's optimizer, delegating to the port's, with each update
    under the ``portbench.optimizer`` profiler range."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, *args, **kw):
        with torch.profiler.record_function(OPT_RANGE):
            return self.opt.update(*args, **kw)


def batch(ctx, k: int) -> Dict[str, np.ndarray]:
    """Batch ``k`` of the run: uniform ids from (seed, k), targets
    shifted by one."""
    t = ctx.traffic
    rng = np.random.default_rng([int(ctx.seed) % (1 << 64), 7, k])
    ids = rng.integers(0, ctx.spec.vocab_size, (t["batch"], t["seq"] + 1),
                       dtype=np.int64)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:]}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """One train state of the port and its step."""

    def __init__(self, ctx):
        from ray_tpu_torch.parallel import default_optimizer, make_train_step
        m, t = ctx.spec, ctx.traffic
        self.ctx = ctx
        self.pcfg = bm.port_config(m, t)
        opt = default_optimizer(**{k: t["optimizer"][k] for k in OPT_KEYS})
        self.init_fn, self.step_fn = make_train_step(
            self.pcfg, device=ctx.device, optimizer=RangedOptimizer(opt),
            model=bm.family_module(m))
        W = bm.draw(m, ctx.seed, ctx.device)
        net = bm.build_program_model(m, self.pcfg, W, trainable=True)
        del W
        self.state = self.init_fn(params=net)
        self.leaves = [bm.leaf_of(n) for n, _ in net.named_parameters()]

    def step(self, b: dict) -> float:
        self.state, met = self.step_fn(self.state, b)
        return float(met["loss"])

    def first_grads(self) -> Dict[tuple, float]:
        """Per leaf, the norm of the first gradient as the optimizer got
        it, from its first moment after one step: mu / (1 - b1)."""
        b1 = float(self.ctx.traffic["optimizer"]["betas"][0])
        mu = self.state.opt_state.mu
        norms = torch.stack([torch.linalg.vector_norm(x, dtype=torch.float32)
                             for x in mu]).cpu().tolist()
        return {leaf: v / (1.0 - b1) for leaf, v in zip(self.leaves, norms)}

    @torch.no_grad()
    def change(self) -> Dict[tuple, float]:
        """Per leaf, the norm of its change since the weights were drawn
        (the initial weights drawn again, one kind at a time)."""
        params = dict(zip(self.leaves, self.state.params.parameters()))
        out = {}
        for kind in bm.kinds(self.ctx.spec):
            w0 = bm.draw_kind(self.ctx.spec, self.ctx.seed, kind,
                              self.ctx.device)
            for (k, i), p in params.items():
                if k == kind:
                    base = w0 if i is None else w0[i]
                    out[(k, i)] = float(torch.linalg.vector_norm(
                        p.float() - base.float(), dtype=torch.float32))
            del w0
        return out

    def free(self) -> None:
        self.state = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def program_readings(ctx, prog: Program, feed) -> dict:
    """The first ``checked_steps`` steps of ``prog`` on ``feed(k)``: the
    loss of each, the first gradient's norms and the change after them,
    and the seconds of the last step."""
    losses, first = [], None
    for k in range(ctx.traffic["checked_steps"]):
        t0 = time.perf_counter()
        losses.append(prog.step(feed(k)))
        last_s = time.perf_counter() - t0
        if k == 0:
            first = prog.first_grads()
    return {"losses": losses, "first": first, "change": prog.change(),
            "last_step_s": last_s}


def reference_readings(ctx, prec=None) -> dict:
    """The reference's readings of the same steps, from the weights drawn
    again and the same batches."""
    from portbench.reference import model as ref_model
    from portbench.reference.train import run_steps
    m, dev = ctx.spec, ctx.device
    W = bm.draw(m, ctx.seed, dev)
    batches = []
    for k in range(ctx.traffic["checked_steps"]):
        b = batch(ctx, k)
        batches.append((torch.as_tensor(b["tokens"], device=dev),
                        torch.as_tensor(b["targets"], device=dev)))
    out = run_steps(W, batches, m, ctx.traffic["optimizer"],
                    lambda kind: bm.draw_kind(m, ctx.seed, kind, dev),
                    prec if prec is not None else ref_model.F32)
    del W
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(prog: dict, ref: dict) -> Tuple[dict, dict]:
    """The numbers compared, and where each was worst:

    - ``loss_gap``: the largest |program - reference| / |reference| over
      the checked steps' losses;
    - ``grad_gap``: over the leaves, the largest gap between the norms of
      the first gradient, over the reference leaf's norm or the median
      leaf's, whichever is larger;
    - ``change_gap``: the same of each leaf's change over the checked
      steps, leaving out leaves whose first gradient in the reference is
      under ``MOVED_SHARE`` of the median leaf's."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["first"].values())

    def worst(p, r, leaves, med):
        best, at = 0.0, None
        for leaf in leaves:
            g = abs(p[leaf] - r[leaf]) / max(r[leaf], med)
            if not g <= best:       # NaN counts as worst
                best, at = g, leaf
                if math.isnan(g):
                    break
        return best, at

    grad_gap, g_at = worst(prog["first"], ref["first"], ref["first"], med_g)
    moved = [leaf for leaf, v in ref["first"].items()
             if v >= MOVED_SHARE * med_g]
    med_c = statistics.median(ref["change"][leaf] for leaf in moved)
    change_gap, c_at = worst(prog["change"], ref["change"], moved, med_c)
    where = {"losses": [prog["losses"], ref["losses"]],
             "grad_gap_leaf": bm.leaf_name(*g_at) if g_at else None,
             "change_gap_leaf": bm.leaf_name(*c_at) if c_at else None,
             "left_out_of_change": len(ref["first"]) - len(moved)}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}, where


def run(ctx) -> dict:
    t = ctx.traffic
    b, s = t["batch"], t["seq"]
    t0 = time.perf_counter()
    prog = Program(ctx)
    sync(ctx.device)
    ctx.log(f"setup: model and optimizer state {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    readings = program_readings(ctx, prog, lambda k: batch(ctx, k))
    ctx.log(f"setup: {t['checked_steps']} checked steps, also the warm-up, "
            f"{time.perf_counter() - t0:.3f} s; losses {readings['losses']}")
    step_s = max(1e-3, readings["last_step_s"])
    t0 = time.perf_counter()
    first = t["checked_steps"]
    n_max = max(256, int(math.ceil(8 * ctx.seconds / step_s))) \
        + t["trace_steps"]
    feed = [batch(ctx, first + k) for k in range(n_max)]
    ctx.log(f"setup: {n_max} batches drawn ahead {time.perf_counter() - t0:.3f} s")
    sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    t_open = time.perf_counter()
    n = 0
    while True:
        if n >= len(feed):
            raise RuntimeError("the window ran out of batches drawn ahead")
        prog.step(feed[n])
        n += 1
        if time.perf_counter() - t_open >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_open
    tokens_per_s = n * b * s / window_s
    ctx.log(f"window: {n} steps in {window_s:.3f} s")
    trace = None
    if ctx.trace:
        with tr_mod.capture(ranges=[OPT_RANGE]) as h:
            for j in range(t["trace_steps"]):
                prog.step(feed[n + j])
            sync(ctx.device)
        trace = h.trace
        ctx.log(f"trace: {len(trace.device_ops)} device ops in "
                f"{trace.window_s:.3f} s, reduced in {h.reduce_s:.3f} s")
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    prog.free()
    t0 = time.perf_counter()
    ref = reference_readings(ctx)
    numbers, where = compare(readings, ref)
    ctx.log(f"reference: {t['checked_steps']} steps "
            f"{time.perf_counter() - t0:.3f} s; {where}")
    hd = ctx.spec.head_dim
    return {
        "end_to_end": {"train_tokens_per_s": tokens_per_s, "setup_s": setup_s},
        "attempted": n, "failed": 0, "numbers": numbers, "trace": trace,
        "memory_peak_bytes": peak,
        "run": {"window_s": window_s, "tokens_per_s": tokens_per_s,
                "seq": s, "traced_steps": t["trace_steps"],
                "attention": {"b": b, "s": s, "h": ctx.spec.n_heads,
                              "kvh": ctx.spec.n_kv_heads, "d": hd,
                              "itemsize": bm.itemsize(ctx.spec.dtype),
                              "with_lse": True}},
    }
