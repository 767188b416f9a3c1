"""The port's engine observability against the JAX engine's: the same tiny
drives (paged, monolithic, speculative and a PD admit) through both
engines, one request trace per request and the same explicit kv_impl,
report the same ``llm_*`` counters and gauges (by tags), the same
histogram counts, the same request spans per trace (components, segments
and their token/KV/prefix/handoff/accept attributes), the same number of
decode batch spans, the same deadline count, and a forensics provider
that holds ``stats`` until ``stop()``.

Both packages keep process-global registries and event buffers, so each
drive runs on an empty registry of its own (the engine registers its
series when it is built; the process's registry is put back after), and
spans are picked out by this file's own trace ids. KV accounting is
held to the formula of ``ray_tpu/llm/engine.py`` ``_kv_account`` in both
cache modes, not to ``tests/test_zz_devmon.py``'s monolithic-era check,
which the JAX engine itself no longer meets.
"""

import asyncio
import itertools
import time
from unittest import mock

import numpy as np
import pytest

import jax

from ray_tpu.llm import pd as jpd
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu.serve.fault import DeadlineExceeded as JaxDeadline
from ray_tpu.util import events as jevents
from ray_tpu.util import forensics as jforensics
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import tracing as jtracing

from ray_tpu_torch import bridge
from ray_tpu_torch.llm import pd as tpd
from ray_tpu_torch.llm.engine import DeadlineExceeded, LLMEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util import events as tevents
from ray_tpu_torch.util import forensics as tforensics
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing

PAGED_KW = dict(max_slots=2, max_len=64, prefill_buckets=(16,),
                cache_dtype="float32", kv_block_size=8, prefix_cache=True)
# a 2048-position monolithic engine starts at 1024 positions: headroom
MONO_KW = dict(PAGED_KW, kv_block_size=0, max_len=2048)
SPEC_KW = dict(max_slots=4, max_len=128, prefill_buckets=(32, 64),
               cache_dtype="float32", kv_block_size=16, spec=True,
               kv_impl="gather")
PD_KW = dict(max_slots=2, max_len=128, prefill_buckets=(16, 32),
             cache_dtype="bfloat16", kv_block_size=16, kv_impl="gather")
SPAN_ATTRS = ("tokens", "kv_bytes", "prefix_hit_tokens", "kv_handoff_bytes",
              "spec_accept_rate")

_IDS = itertools.count(0x7e57)


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 127, n)]


def _periodic(seed, n=48, period=16):
    return (_prompt(seed, period) * (n // period + 1))[:n]


A = _prompt(10, 20)
PAGED_REQ = [(A, 4), (_prompt(11, 40), 8), (_prompt(12, 6), 6),
             (A + _prompt(13, 6), 5)]
SPEC_REQ = [(_periodic(9), 32), (_prompt(5, 40), 32), (_periodic(4), 32),
            (_prompt(11, 30), 32)]
PD_REQ = [([3, 7, 11, 19, 2], 6), (_prompt(1, 20), 5)]


@pytest.fixture(scope="module")
def models():
    args = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, ffn_dim=128, dtype="float32",
                attn_impl="reference")
    jcfg, tcfg = jllama.tiny(**args), tllama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, params, tcfg, bridge.params_from_numpy(tree, tcfg, "cpu")


def _series(metrics):
    """{(name, labels): value} of every llm_*/serve_* counter and gauge
    and {(name + "_count", labels): count} of every such histogram in
    the registry."""
    out = {}
    with metrics._LOCK:
        regs = list(metrics._REGISTRY.values())
        for m in regs:
            if not m.name.startswith(("llm_", "serve_")):
                continue
            if m.kind == "histogram":
                for key, counts in m._counts.items():
                    out[(m.name + "_count", key)] = float(sum(counts))
            else:
                for key, v in m._values.items():
                    out[(m.name, key)] = float(v)
    return out


class _Pkg:
    """One package's registry, events, tracing and forensics."""

    def __init__(self, metrics, events, tracing, forensics):
        self.metrics, self.events = metrics, events
        self.tracing, self.forensics = tracing, forensics


JAX = _Pkg(jmetrics, jevents, jtracing, jforensics)
PORT = _Pkg(tmetrics, tevents, ttracing, tforensics)


def _drive(pkg, make_engine, requests, payloads=None):
    """An engine from ``make_engine()`` on an empty registry, every
    request concurrently, each under its own fresh TraceContext bound
    inside its coroutine. Returns (token streams, {"series", "spans" per
    trace id, "batches", "windows", "stats", "provider",
    "provider_after_stop"})."""
    ids = [(f"{next(_IDS):032x}", f"{next(_IDS):016x}") for _ in requests]

    async def one(eng, i, p, n):
        pkg.tracing.set_request_context(pkg.tracing.TraceContext(*ids[i]))
        extra = {} if payloads is None else {"prefilled": payloads[i]}
        return await eng.generate(p, max_new_tokens=n, **extra)

    async def go():
        eng = make_engine()
        outs = await asyncio.gather(*[one(eng, i, p, n) for i, (p, n)
                                      in enumerate(requests)])
        name = f"llm_engine:{id(eng):x}"
        prov = pkg.forensics.provider_states().get(name)
        stats = eng.stats
        await eng.stop()
        return outs, stats, prov, pkg.forensics.provider_states().get(name)

    t0 = time.time()
    with mock.patch.object(pkg.metrics, "_REGISTRY", {}):
        outs, stats, prov, after_stop = asyncio.run(go())
        series = _series(pkg.metrics)
    trace_ids = {t for t, _ in ids}
    evs = pkg.events.dump()
    spans = {t: sorted(
        (e["component"], e["seg"]) + tuple(e.get(a) for a in SPAN_ATTRS)
        for e in evs if e.get("cat") == "request" and e.get("name") == "span"
        and e.get("trace") == t) for t in trace_ids}
    batches = [e for e in evs if e.get("cat") == "request"
               and e.get("name") == "batch"
               and trace_ids & set(e.get("links") or ())]
    windows = [e for e in evs if e.get("cat") == "device_window"
               and e.get("ts", 0) >= t0 - 1e-3]
    return [o["tokens"] for o in outs], dict(
        series=series, spans=[spans[t] for t, _ in ids], batches=batches,
        windows=windows, stats=stats, provider=prov,
        provider_after_stop=after_stop)


def _both(models, kw, requests, payloads=None):
    jcfg, params, tcfg, model = models
    want = _drive(JAX, lambda: JaxEngine(jcfg, params, **kw), requests,
                  payloads and payloads[0])
    got = _drive(PORT, lambda: LLMEngine(tcfg, model, device="cpu", **kw),
                 requests, payloads and payloads[1])
    return got, want


def _kv_formula(stats, eng_bytes):
    """llm_kv_cache_bytes / _headroom_bytes from the JAX engine's
    _kv_account: paged (block bytes, stats) or monolithic (cache bytes,
    per-token bytes, slots, max_len, cache_len)."""
    if stats["paged"]:
        bb = eng_bytes
        return (bb * (stats["blocks_used"] + stats["blocks_cached"]),
                bb * stats["blocks_free"])
    cur, per_tok, slots, max_len = eng_bytes
    return cur, per_tok * slots * (max_len - stats["cache_len"])


def _check_common(got, want):
    (g_toks, g), (w_toks, w) = got, want
    assert g_toks == w_toks
    assert g["series"] == w["series"]
    assert g["spans"] == w["spans"]
    for spans in g["spans"]:
        segs = [s[:2] for s in spans]
        assert sorted(segs) == [("engine", "generate"), ("engine", "prefill"),
                                ("engine", "queue")]
    assert len(g["batches"]) == len(w["batches"]) > 0
    assert [b["kv_impl"] for b in g["batches"]] == \
        [b["kv_impl"] for b in w["batches"]]
    assert [(b["block"], b["slots"], b.get("spec_k"),
             b["gather_bytes_avoided"]) for b in g["batches"]] == \
        [(b["block"], b["slots"], b.get("spec_k"), b["gather_bytes_avoided"])
         for b in w["batches"]]
    assert sorted(x["seg"] for x in g["windows"]) == \
        sorted(x["seg"] for x in w["windows"])
    # the forensics provider holds stats while the engine runs, not after
    assert g["provider"] == g["stats"] and w["provider"] == w["stats"]
    assert g["provider_after_stop"] is None is w["provider_after_stop"]


def _count(series, name, **tags):
    return series.get((name, tuple(sorted(tags.items()))), 0.0)


@pytest.mark.parametrize("kv_impl", ["paged_flash", "gather"])
def test_paged_drive_reports_the_jax_series(models, kv_impl):
    got, want = _both(models, dict(PAGED_KW, kv_impl=kv_impl), PAGED_REQ)
    _check_common(got, want)
    s, stats = got[1]["series"], got[1]["stats"]
    steps = _count(s, "llm_paged_attn_steps_total", impl=kv_impl)
    assert steps == sum(b["block"] for b in got[1]["batches"]) > 0
    assert _count(s, "llm_prefix_hit_tokens_total") == \
        stats["prefix_hit_tokens"] > 0
    assert _count(s, "llm_ttft_wall_s_count") == len(PAGED_REQ)
    assert _count(s, "llm_queue_s_count") == len(PAGED_REQ)
    w = 64 // 8
    bb = 2 * 2 * 8 * 2 * 16 * 4           # k+v, layers, block, kvh, hd, f32
    avoided = steps * 2 * w * bb if kv_impl == "paged_flash" else 0
    assert _count(s, "llm_kv_gather_bytes_avoided_total") == avoided
    kv, head = _kv_formula(stats, bb)
    assert _count(s, "llm_kv_cache_bytes") == kv > 0
    assert _count(s, "llm_kv_cache_headroom_bytes") == head
    # generate's kv_bytes: (prompt + generated) positions at the block's
    # per-token bytes
    for (p, n), spans in zip(PAGED_REQ, got[1]["spans"]):
        gen = next(x for x in spans if x[1] == "generate")
        assert gen[2] == n and gen[3] == int(bb / 8 * (len(p) + n))
    assert {b["kv_impl"] for b in got[1]["batches"]} == {kv_impl}


def test_monolithic_drive_reports_the_jax_series(models):
    got, want = _both(models, MONO_KW, PAGED_REQ)
    _check_common(got, want)
    s, stats = got[1]["series"], got[1]["stats"]
    assert not stats["paged"] and stats["cache_len"] == 1024
    cur = 2 * 2 * 2 * 1024 * 2 * 16 * 4    # k+v, layers, slots, len, kvh, hd
    kv, head = _kv_formula(stats, (cur, cur / (2 * 1024), 2, 2048))
    assert _count(s, "llm_kv_cache_bytes") == kv
    assert _count(s, "llm_kv_cache_headroom_bytes") == head > 0
    assert not any(k[0] == "llm_paged_attn_steps_total" for k in s)
    assert {b["kv_impl"] for b in got[1]["batches"]} == {"monolithic"}


def test_spec_drive_reports_the_jax_series(models):
    got, want = _both(models, SPEC_KW, SPEC_REQ)
    _check_common(got, want)
    s = got[1]["series"]
    drafted = _count(s, "llm_spec_tokens_total", kind="drafted")
    assert drafted > 0
    assert drafted == _count(s, "llm_spec_tokens_total", kind="accepted") \
        + _count(s, "llm_spec_tokens_total", kind="rejected")
    assert any(b.get("spec_k") for b in got[1]["batches"])
    assert 0 <= _count(s, "llm_spec_accept_rate") <= 1
    rates = [x[-1] for spans in got[1]["spans"] for x in spans
             if x[1] == "generate" and x[-1] is not None]
    assert rates


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_pd_admit_counts_the_jax_handoff_bytes(models, kv_block_size):
    """Each engine admits its own package's bf16 payloads: the same
    series, handoff counter and handoff span attribute."""
    jcfg, params, tcfg, model = models
    kw = dict(PD_KW, kv_block_size=kv_block_size)
    pre = dict(prefill_buckets=kw["prefill_buckets"], max_len=kw["max_len"],
               cache_dtype="bfloat16")
    jp = jpd.PrefillEngine(jcfg, params, **pre)
    tp = tpd.PrefillEngine(tcfg, model, device="cpu", **pre)
    payloads = ([jp.prefill(p) for p, _ in PD_REQ],
                [tp.prefill(p) for p, _ in PD_REQ])
    got, want = _both(models, kw, PD_REQ, payloads)
    _check_common(got, want)
    shipped = sum(p["k"].nbytes + p["v"].nbytes for p in payloads[0])
    assert _count(got[1]["series"], "llm_kv_handoff_bytes_total") == shipped
    assert shipped == sum(p["k"].nbytes + p["v"].nbytes for p in payloads[1])
    assert [x for spans in got[1]["spans"] for x in spans
            if x[1] == "generate"][0][5] > 0


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_deadline_counter_and_kv_gauges_mid_drive(models, pkg):
    """A request whose deadline passes while queued is refused at
    admission and counted at the engine once, in both packages; while a
    streamed request holds its blocks, the KV gauges follow the formula."""
    jcfg, params, tcfg, model = models
    eng = (JaxEngine(jcfg, params, **PAGED_KW) if pkg is JAX else
           LLMEngine(tcfg, model, device="cpu", **PAGED_KW))
    err = JaxDeadline if pkg is JAX else DeadlineExceeded
    m = pkg.metrics
    before = _series(m)

    async def go():
        t = asyncio.ensure_future(eng.generate(
            A, max_new_tokens=4, deadline_ts=time.time() + 0.05))
        await asyncio.sleep(0)       # the request is queued
        time.sleep(0.1)              # its deadline passes before admission
        with pytest.raises(err):
            await t
        mid = None
        async for _ in eng.generate_stream(PAGED_REQ[1][0],
                                           max_new_tokens=3):
            if mid is None:
                mid = (eng.stats, _series(m))
        await eng.stop()
        return mid

    (stats, mid) = asyncio.run(go())
    after = _series(m)
    key = ("serve_deadline_exceeded_total", (("where", "engine"),))
    assert after[key] - before.get(key, 0.0) == 1
    assert stats["blocks_used"] > 0
    bb = 2 * 2 * 8 * 2 * 16 * 4
    kv, head = _kv_formula(stats, bb)
    assert mid[("llm_kv_cache_bytes", ())] == kv
    assert mid[("llm_kv_cache_headroom_bytes", ())] == head
