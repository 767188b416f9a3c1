"""The port's request tracing (ray_tpu_torch/util/tracing.py) against the
JAX package's (ray_tpu/util/tracing.py), in one process with separate
event buffers: request and batch spans recorded with fixed ids and times
give the same event dicts (apart from ``pid``), the tail-sampling
decision and the root span agree, and ``filter_trace`` and ``to_chrome``
give the same output on the same events."""

import json
import time

import pytest

from ray_tpu.util import events as jevents
from ray_tpu.util import tracing as jtracing

from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import tracing as ttracing

PAIRS = [(jtracing, jevents), (ttracing, tevents)]
T = "a1" * 16
T2 = "b2" * 16


@pytest.fixture
def bufs(monkeypatch):
    """Both packages' event buffers empty (restored afterwards), span ids
    minted from a counter, and a fixed wall clock."""
    for tr, ev in PAIRS:
        monkeypatch.setattr(ev, "_BUFS", {})
        ids = iter(range(1, 1000))
        monkeypatch.setattr(tr, "new_span_id",
                            lambda ids=ids: f"{next(ids):016x}")
    monkeypatch.setattr(time, "time", lambda: 1750000000.5)


def _no_pid(evs):
    return [{k: v for k, v in e.items() if k != "pid"} for e in evs]


def _spans(tr):
    ctx = tr.TraceContext(T, "c3" * 8)
    sid = tr.record_request_span("engine", "queue", ctx, ctx.span_id,
                                 100.0, 100.25)
    tr.record_request_span("engine", "prefill", ctx, ctx.span_id, 100.25,
                           100.5, tokens=20)
    tr.record_request_span("engine", "generate", ctx, ctx.span_id, 100.0,
                           101.0, span_id="d4" * 8, error=True, tokens=7,
                           kv_bytes=4096, prefix_hit_tokens=16,
                           kv_handoff_bytes=2048, spec_accept_rate=0.5)
    tr.record_batch_span("engine", "decode", [T, T2], 100.5, 100.75,
                         block=8, slots=2, kv_impl="paged_flash",
                         gather_bytes_avoided=65536)
    tr.record_batch_span("engine", "decode", [], 100.5, 100.75, block=1)
    tr.record_batch_span("engine", "decode", [T], 100.8, 100.9, block=3,
                         slots=1, kv_impl="paged_flash",
                         gather_bytes_avoided=0, spec_k=4)
    kept = [tr.finish_request(ctx, 99.0, 102.0, status="ok"),
            tr.finish_request(tr.TraceContext(T2, "e5" * 8), 99.0, 99.01,
                              status="deadline")]
    return sid, kept


def test_request_and_batch_spans_match_jax(bufs):
    out = [(_spans(tr), _no_pid(ev.dump())) for tr, ev in PAIRS]
    assert out[1] == out[0]
    (sid, kept), evs = out[1]
    assert sid == f"{1:016x}" and kept == [True, True]
    assert [e["seg"] for e in evs if e["name"] == "batch"] == \
        ["decode", "decode"]                   # the unlinked batch: none


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5, 1.0, None])
def test_sample_keep_matches_jax(rate):
    ids = [f"{i * 2654435761 % 2 ** 128:032x}" for i in range(200)]
    for flags in ({}, {"error": True}, {"slow": True}):
        assert [ttracing.sample_keep(t, rate=rate, **flags) for t in ids] \
            == [jtracing.sample_keep(t, rate=rate, **flags) for t in ids]


def test_context_and_traceparent_match_jax():
    for tr in (ttracing, jtracing):
        ctx = tr.parse_traceparent(f"00-{T}-{'c3' * 8}-01")
        assert ctx == (T, "c3" * 8) and tr.format_traceparent(ctx) == \
            f"00-{T}-{'c3' * 8}-01"
        assert tr.parse_traceparent(f"00-{'0' * 32}-{'c3' * 8}-01") is None
        assert tr.parse_traceparent("garbage") is None
        assert tr.current_context() is None
        tok = tr.set_request_context(ctx)
        assert tr.current_context() == ctx and tr.current_trace_id() == T
        assert tr.wire_context() == tr.format_traceparent(ctx)
        tr.reset_request_context(tok)
        assert tr.current_context() is None
        minted = tr.mint_context()
        assert len(minted.trace_id) == 32 and len(minted.span_id) == 16


def test_request_layer_off_records_nothing(bufs, monkeypatch):
    for tr, ev in PAIRS:
        monkeypatch.setattr(tr, "_REQ", False)
        assert _spans(tr)[0] == ""
        assert ev.dump() == [] and tr.mint_context() is None


def _events():
    """A mixed buffer: two request traces with a shared decode batch,
    device windows and a compile, task exec spans with a submit edge,
    a train-step trace with its collective rounds and pipeline ops, a
    health instant and an autoscale instant, on two nodes."""
    ev = []
    for trace, base, node in ((T, 10.0, "aa"), (T2, 10.2, "bb")):
        for seg, t0, t1 in (("queue", 0.0, 0.1), ("prefill", 0.1, 0.3),
                            ("generate", 0.0, 1.0)):
            ev.append({"cat": "request", "name": "span", "trace": trace,
                       "span": f"{trace[:4]}{seg}", "parent": "root" + trace,
                       "component": "engine", "seg": seg, "ts": base + t0,
                       "dur": t1 - t0, "error": False, "node": node,
                       "tokens": 5})
        ev.append({"cat": "request", "name": "span", "trace": trace,
                   "span": "root" + trace, "parent": "", "component":
                   "proxy", "seg": "request", "root": True, "status": "ok",
                   "keep": "sampled", "ts": base - 0.01, "dur": 1.05,
                   "node": node})
    ev.append({"cat": "request", "name": "batch", "span": "b1",
               "links": [T, T2], "component": "engine", "seg": "decode",
               "ts": 10.4, "dur": 0.2, "block": 8, "slots": 2,
               "kv_impl": "paged_flash", "gather_bytes_avoided": 1})
    ev.append({"cat": "device_window", "name": "window", "seg": "decode",
               "ts": 10.4, "dur": 0.2, "device": "cuda:0", "trace": T})
    ev.append({"cat": "device", "name": "compile", "fn": "paged.cu",
               "ts": 9.0, "dur": 3.0, "cache_hit": False, "trace": T})
    ev.append({"cat": "device", "name": "recompile_storm", "fn": "f",
               "ts": 9.5, "count": 3, "window_s": 60.0})
    ev.append({"cat": "device", "name": "hbm", "device": "cuda:0",
               "used": 1, "limit": 2, "peak": 1, "ts": 9.6})
    ev.append({"cat": "trace", "name": "submit", "child": "t2",
               "parent": "t1", "ts": 1.0})
    for task, ts in (("t1", 1.0), ("t2", 1.5)):
        ev.append({"cat": "trace", "name": "exec", "ph": "X", "task": task,
                   "kind": "task", "target": "f", "ts": ts, "dur": 0.3,
                   "error": False, "batch": 1, "pid": 7, "trace": T})
    ev.append({"cat": "request", "name": "span", "trace": "c" * 32,
               "span": "st", "parent": "", "component": "train",
               "seg": "step", "ts": 20.0, "dur": 1.0, "step": 3,
               "group": "g", "pgroup": "pg", "pstep": 2})
    for rank in range(2):
        ev.append({"cat": "collective", "name": "round", "kind": "allreduce",
                   "rank": rank, "size": 2, "group": "g.n0", "cid": 1,
                   "step": 3, "ts": 20.1 + rank * 0.01, "dur": 0.2})
        ev.append({"cat": "collective", "name": "chunk", "phase": "send",
                   "rank": rank, "seg": 0, "bytes": 64, "cid": 1,
                   "ts": 20.12, "dur": 0.01, "step": 3, "group": "g"})
    for stage in range(2):
        ev.append({"cat": "pipeline", "name": "op", "stage": stage,
                   "chain": 0, "mb": 0, "kind": "F", "step": 2,
                   "group": "pg", "ts": 20.2 + stage * 0.1, "dur": 0.05})
    ev.append({"cat": "pipeline", "name": "step", "stage": 0, "step": 2,
               "group": "pg", "ts": 20.2, "dur": 0.5, "bubble_s": 0.1})
    ev.append({"cat": "health", "name": "alert", "objective": "ttft",
               "tier": "page", "state": "firing", "trace": T, "ts": 11.0})
    ev.append({"cat": "serve", "name": "autoscale", "deployment": "llm",
               "direction": "up", "target": 3, "prev_target": 2,
               "ts": 11.5})
    return ev


@pytest.mark.parametrize("trace_id", [None, T, T2, "c" * 32, "none"])
@pytest.mark.parametrize("offsets", [None, {"aa": 0.5, "bb": -0.25}])
def test_filter_trace_and_to_chrome_match_jax(tmp_path, trace_id, offsets):
    evs = _events()
    if trace_id is not None:
        assert ttracing.filter_trace(evs, trace_id) == \
            jtracing.filter_trace(evs, trace_id)
    paths = [tmp_path / "j.json", tmp_path / "t.json"]
    outs = [tr.to_chrome(evs, path=str(p), clock_offsets=offsets,
                         trace_id=trace_id)
            for tr, p in zip((jtracing, ttracing), paths)]
    assert outs[1] == outs[0]
    assert json.loads(paths[1].read_text()) == \
        json.loads(paths[0].read_text())
    if trace_id is None:
        assert {r["ph"] for r in outs[1]} >= {"X", "I", "s", "f"}


def _tasks(tr):
    tok = tr.current_span.set("p" * 16)
    try:
        tr.record_submit("c" * 16, "task", "f")
        tr.record_exec("c" * 16, "task", "f", 10.0, 10.5)
        tr.record_exec("d" * 16, "actor", "A.m", 11.0, 11.25, error=True,
                       batch=3, trace=T)
    finally:
        tr.current_span.reset(tok)
    tr.record_submit("e" * 16, "actor", "A.m")


@pytest.mark.parametrize("trace,events", [(True, True), (False, True),
                                          (True, False), (False, False)],
                         ids=["both", "events_only", "trace_only", "off"])
def test_task_spans_match_jax(bufs, monkeypatch, trace, events):
    """The runtime's task spans: ``record_submit`` edges (with the
    submitting task as parent) and ``record_exec`` spans give the JAX
    package's events under each setting of the RAY_TPU_TRACE_TASKS and
    RAY_TPU_TASK_EVENTS switches (exec records stop only when both are
    off), and lay out the same chrome trace."""
    out = []
    for tr, ev in PAIRS:
        monkeypatch.setattr(tr, "_ENABLED", trace)
        monkeypatch.setattr(tr, "_EVENTS", events)
        assert tr.enabled() is trace
        _tasks(tr)
        evs = ev.dump()
        out.append((_no_pid(evs), tr.to_chrome(evs)))
    assert out[1] == out[0]
    names = [e["name"] for e in out[1][0]]
    assert names.count("submit") == (2 if trace else 0)
    assert names.count("exec") == (2 if trace or events else 0)
