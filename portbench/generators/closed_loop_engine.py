"""A closed loop of clients against the port's ``LLMEngine``, in process.

Each client sends a request, reads its answer as a stream, and sends the
next when the answer is complete. The sizes of the requests are a fixed
pool (``pool``: prompt lengths at the quantiles of their distribution,
answer lengths at theirs, paired by a fixed shuffle), the same for
every seed; the seed orders the pool (again each time it runs out) and
draws each request's token ids, so two seeds do the same work in
another order. The window opens once every client has completed a
request (that first round warms up every prefill and decode shape the
mix uses) and lasts ``--seconds``; what it reports is over the requests
completed inside it. With ``--trace 1`` a profiled stretch of
``trace_seconds`` follows, still under load. Then the engine stops, its
state is freed, and the reference reads a sample of the completed
requests.
"""

from __future__ import annotations

import asyncio
import gc
import math
import time
from typing import List

import numpy as np
import torch

from portbench.bench import model as bm
from portbench.bench import trace as tr_mod
from portbench.work import flops as fl


def pool(traffic: dict) -> List[tuple]:
    """The fixed (prompt tokens, answer tokens) of the mix."""
    n = int(traffic["pool"]["size"])
    u = (np.arange(n) + 0.5) / n

    def draw(spec, q):
        lo, hi = float(spec["low"]), float(spec["high"])
        if spec["dist"] == "loguniform":
            return np.rint(lo * (hi / lo) ** q).astype(int)
        if spec["dist"] == "uniform":
            return np.rint(lo + (hi - lo) * q).astype(int)
        raise ValueError(f"unknown length distribution {spec['dist']!r}")

    prompts = draw(traffic["prompt_tokens"], u)
    rng = np.random.default_rng(int(traffic["pool"]["seed"]))
    outs = draw(traffic["output_tokens"], u[rng.permutation(n)])
    return list(zip(prompts.tolist(), outs.tolist()))


class Requests:
    """The run's request stream: the k-th request's sizes and ids."""

    def __init__(self, seed: int, traffic: dict, vocab: int):
        self.seed, self.sizes, self.vocab = int(seed), pool(traffic), vocab
        self.k = 0
        self.order: List[int] = []

    def next(self):
        k = self.k
        self.k += 1
        n = len(self.sizes)
        if k % n == 0:
            rng = np.random.default_rng([self.seed % (1 << 64), 11, k // n])
            self.order = rng.permutation(n).tolist()
        p, o = self.sizes[self.order[k % n]]
        ids = np.random.default_rng([self.seed % (1 << 64), 12, k]).integers(
            0, self.vocab, p).tolist()
        return k, ids, o


class K4Calls:
    """Records the live lengths of each decode-attention call while on:
    a wrapper around the op the port's decode step calls."""

    def __init__(self):
        import ray_tpu_torch.ops.paged_attention as pa
        self.pa, self.orig, self.calls = pa, pa.paged_attention, []

    def __enter__(self):
        orig, calls = self.orig, self.calls

        def recorded(q, k_pool, v_pool, tables, lengths, *a, **kw):
            calls.append((lengths.detach().clone(), tuple(q.shape), q.dtype,
                          k_pool.dtype))
            return orig(q, k_pool, v_pool, tables, lengths, *a, **kw)
        # the op counts its launches on the module's name for it
        recorded.launches = orig.launches
        self.pa.paged_attention = self.recorded = recorded
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.recorded.launches
        self.pa.paged_attention = self.orig

    def per_call(self) -> List[dict]:
        out = []
        for lengths, (b, kvh, g, hd), qdt, pdt in self.calls:
            out.append({"lengths": lengths.cpu().tolist(), "kvh": kvh,
                        "g": g, "d": hd,
                        "pool_itemsize": torch.empty((), dtype=pdt).element_size(),
                        "q_itemsize": torch.empty((), dtype=qdt).element_size()})
        return out


def percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def build_engine(ctx):
    from ray_tpu_torch.llm.engine import LLMEngine
    m, e = ctx.spec, ctx.traffic["engine"]
    pcfg = bm.port_config(m, ctx.traffic)
    W = bm.draw(m, ctx.seed, ctx.device)
    net = bm.build_program_model(m, pcfg, W, trainable=False)
    del W
    eng = LLMEngine(pcfg, net, max_slots=e["max_slots"], max_len=e["max_len"],
                    prefill_buckets=tuple(e["prefill_buckets"]),
                    cache_dtype=e["cache_dtype"],
                    seed=int(ctx.seed) % (1 << 63),
                    steps_per_sync=e["steps_per_sync"],
                    kv_block_size=e["kv_block_size"],
                    prefix_cache=e["prefix_cache"], kv_impl=e["kv_impl"],
                    spec=e["spec"], device=ctx.device)
    return eng


async def _drive(ctx, eng, load_s: float, trace: bool) -> dict:
    """Clients against ``eng``: the first round, then ``load_s`` seconds
    of window, then (with ``trace``) the profiled stretch."""
    t = ctx.traffic
    reqs = Requests(ctx.seed, t, ctx.spec.vocab_size)
    done: List[dict] = []
    stop = {"now": False}
    firsts = [False] * int(t["clients"])
    all_first = asyncio.Event()

    async def client(ci: int):
        while not stop["now"]:
            k, prompt, n_out = reqs.next()
            rec = {"k": k, "prompt": prompt, "n_out": n_out, "out": [],
                   "t_sub": time.perf_counter(), "t_first": None,
                   "t_last": None, "error": None}
            try:
                async for tok in eng.generate_stream(
                        prompt, max_new_tokens=n_out, temperature=0.0,
                        eos_id=None):
                    now = time.perf_counter()
                    if rec["t_first"] is None:
                        rec["t_first"] = now
                    rec["t_last"] = now
                    rec["out"].append(int(tok))
            except Exception as e:  # noqa: BLE001 — a failed request is counted
                rec["error"] = repr(e)
            rec["t_end"] = time.perf_counter()
            done.append(rec)
            if not firsts[ci]:
                firsts[ci] = True
                if all(firsts):
                    all_first.set()

    tasks = [asyncio.create_task(client(i)) for i in range(int(t["clients"]))]
    try:
        await all_first.wait()
        t_open = time.perf_counter()
        ctx.log(f"setup: first round of {len(done)} requests done "
                f"{t_open - ctx.t_start:.3f} s after start")
        await asyncio.sleep(load_s)
        t_close = time.perf_counter()
        traced = None
        if trace:
            with K4Calls() as calls:
                with tr_mod.capture() as h:
                    await asyncio.sleep(float(t["trace_seconds"]))
            traced = (h.trace, calls.per_call())
            ctx.log(f"trace: {len(h.trace.device_ops)} device ops, "
                    f"{len(calls.calls)} decode-attention calls, reduced in "
                    f"{h.reduce_s:.3f} s")
    finally:
        stop["now"] = True
        await eng.stop()
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    return {"done": done, "t_open": t_open, "t_close": t_close,
            "traced": traced}


def window_requests(res: dict) -> tuple:
    """(completed, failed) requests that ended inside the window."""
    inside = [r for r in res["done"]
              if res["t_open"] <= r["t_end"] <= res["t_close"]]
    ok = [r for r in inside
          if r["error"] is None and len(r["out"]) == r["n_out"]]
    return ok, [r for r in inside if r not in ok]


def sample(ctx, ok: List[dict]) -> List[dict]:
    """The requests the reference reads: the one with the most served
    tokens, then others in an order drawn from the seed, until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    chk = ctx.traffic["check"]
    if not ok:
        return []
    first = max(ok, key=lambda r: (len(r["out"]), len(r["prompt"]), -r["k"]))
    rest = [r for r in ok if r is not first]
    rng = np.random.default_rng([int(ctx.seed) % (1 << 64), 13])
    out, n = [first], len(first["out"])
    for j in rng.permutation(len(rest)).tolist():
        if n >= chk["min_tokens"] or len(out) >= chk["max_requests"]:
            break
        out.append(rest[j])
        n += len(rest[j]["out"])
    return out


def token_gaps(ctx, picked: List[dict], precs=()) -> dict:
    """The reference's reading of the served tokens of ``picked``: the
    widest gap by which a served token's logit lies below the
    reference's best at its position (``token_gap``), and for each
    precision in ``precs`` the widest gap of the token that precision
    puts first, at the same positions (the control's reading)."""
    from portbench.reference import model as ref
    ref.no_tf32()
    m, dev = ctx.spec, ctx.device
    W = bm.draw(m, ctx.seed, dev)
    worst = {"token_gap": 0.0}
    worst.update({p.name: 0.0 for p in precs})
    served = 0
    for r in picked:
        seq = torch.tensor(r["prompt"] + r["out"][:-1], device=dev)
        rows = torch.arange(len(r["prompt"]) - 1, seq.shape[0], device=dev)
        got = torch.tensor(r["out"], device=dev)
        lg = ref.logits_at(W, seq, rows, m)
        best = lg.max(-1).values
        gap = best - lg.gather(-1, got[:, None])[:, 0]
        worst["token_gap"] = max(worst["token_gap"], float(gap.max()))
        served += len(r["out"])
        for p in precs:
            pick = ref.logits_at(W, seq, rows, m, p).argmax(-1)
            g = best - lg.gather(-1, pick[:, None])[:, 0]
            worst[p.name] = max(worst[p.name], float(g.max()))
        del lg
    del W
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    worst["served_tokens"] = served
    return worst


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    t0 = time.perf_counter()
    eng = build_engine(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.log(f"setup: weights and engine {time.perf_counter() - t0:.3f} s")
    res = asyncio.run(_drive(ctx, eng, ctx.seconds, ctx.trace))
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    del eng
    free(ctx.device)
    ok, failed = window_requests(res)
    window_s = res["t_close"] - res["t_open"]
    setup_s = res["t_open"] - ctx.t_start
    m = ctx.spec
    gen = sum(len(r["out"]) for r in ok)
    ttft = [(r["t_first"] - r["t_sub"]) * 1e3 for r in ok]
    tpot = [(r["t_last"] - r["t_first"]) / (len(r["out"]) - 1) * 1e3
            for r in ok if len(r["out"]) > 1]
    ctx.log(f"window: {len(ok)} requests completed, {len(failed)} failed, "
            f"{gen} tokens in {window_s:.3f} s")
    e2e = {"setup_s": setup_s}
    tails = {}
    if ok:
        e2e["serve_tokens_per_s"] = gen / window_s
        tails = {"ttft_p95_ms": percentile(ttft, 95),
                 "tpot_p95_ms": percentile(tpot, 95)}
        ctx.log(f"window: ttft p50 {percentile(ttft, 50):.3f} ms, p95 "
                f"{tails['ttft_p95_ms']:.3f} ms; tpot p50 "
                f"{percentile(tpot, 50):.3f} ms, p95 "
                f"{tails['tpot_p95_ms']:.3f} ms")
    t1 = time.perf_counter()
    picked = sample(ctx, ok)
    numbers = token_gaps(ctx, picked) if picked else {"token_gap": math.inf}
    ctx.log(f"reference: {len(picked)} requests, "
            f"{numbers.get('served_tokens', 0)} served tokens, "
            f"{time.perf_counter() - t1:.3f} s")
    trace, calls = res["traced"] if res["traced"] else (None, [])
    return {
        "end_to_end": e2e, "attempted": len(ok) + len(failed),
        "failed": len(failed), "numbers": {"token_gap": numbers["token_gap"]},
        "trace": trace, "memory_peak_bytes": peak,
        "run": {"window_s": window_s,
                "window_flops": sum(fl.request_flops(m, len(r["prompt"]),
                                                     len(r["out"]))
                                    for r in ok),
                "decode_calls": calls, **tails},
    }
