"""The port's metrics registry (ray_tpu_torch/util/metrics.py) against the
JAX package's (ray_tpu/util/metrics.py), in one process with separate
registries: the same sequence of Counter/Gauge/Histogram operations,
with tags, boundaries and exemplars, renders byte-identical Prometheus
text (``render_all``, ``render_labeled``, ``strip_exemplars``) and the
same ``snapshot()``. The port's metric catalogs pass the repo's metric
lint."""

import importlib.util
import pathlib
import time

import pytest

from ray_tpu.util import metrics as jmetrics

from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm import kvcache as tkv
from ray_tpu_torch.llm import spec as tspec
from ray_tpu_torch.serve import fault as tfault
from ray_tpu_torch.train import pipeline as tpipeline
from ray_tpu_torch.train import zero as tzero
from ray_tpu_torch.util import devmon as tdevmon
from ray_tpu_torch.util import metrics as tmetrics

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def clean(monkeypatch):
    """Both packages on empty registries (restored afterwards), and a
    fixed wall clock for the exemplars' timestamps."""
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod, "_REGISTRY", {})
        monkeypatch.setattr(mod, "_COLLECTORS", [])
        monkeypatch.setattr(mod, "_REMOTE", {})
    monkeypatch.setattr(time, "time", lambda: 1750000000.125)


def _counters(m):
    c = m.Counter("req_total", "Requests served", tag_keys=("route",))
    c.inc()
    c.inc(2, tags={"route": "/a"})
    c.inc(0.5, tags={"route": '/q"x'})          # a quote in a label
    big = m.Counter("big_total", "Past float %g precision")
    big.inc(1e7)
    big.inc(40)
    m.Counter("zero_total", "Registered, never incremented")


def _gauges(m):
    g = m.Gauge("depth", "Queue depth", tag_keys=("q",))
    g.set(3, tags={"q": "a"})
    g.inc(tags={"q": "a"})
    g.dec(0.25, tags={"q": "b"})
    g.set(1.0 / 3.0)
    m.Gauge("depth", "Same name: shared storage").inc(2)


def _histograms(m):
    h = m.Histogram("lat_s", "Latency")
    for v in (0.001, 0.005, 0.0051, 0.3, 11.0):
        h.observe(v)
    h.observe(0.02, tags={"route": "/a"}, exemplar="ab" * 16)
    h.observe(0.021, tags={"route": "/a"}, exemplar="cd" * 16)
    h.observe(99.0, tags={"route": "/a"}, exemplar="ef" * 16)
    b = m.Histogram("batch_size", "Slots", boundaries=(8, 1, 4, 2))
    for v in (1, 2, 3, 8, 9, 0):
        b.observe(v, exemplar="" if v else None)
    # same name and boundaries: one series; other boundaries: its own
    m.Histogram("batch_size", "again", boundaries=(1, 2, 4, 8)).observe(5)


def _mixed(m):
    _counters(m)
    _gauges(m)
    _histograms(m)
    m.register_collector(lambda: "# collected\nextra_total 7")
    m.merge_remote("node:1", "pushed_total{w=\"1\"} 3")
    assert m.core_metric("counter", "core_total", "Core") is \
        m.core_metric("counter", "core_total", "ignored")
    m.core_metric("gauge", "core_level", "Core level").set(9)
    m.core_metric("histogram", "core_s", "Core seconds").observe(0.5,
                                                                exemplar="x")
    with pytest.raises(ValueError, match="already registered"):
        m.Gauge("req_total", "a counter's name")


@pytest.mark.parametrize("case", [_counters, _gauges, _histograms, _mixed],
                         ids=lambda f: f.__name__.strip("_"))
def test_exposition_text_and_snapshot_match_jax(clean, case):
    out = {}
    for mod in (jmetrics, tmetrics):
        case(mod)
        text = mod.render_all()
        out[mod] = (text, mod.strip_exemplars(text), mod.snapshot(),
                    mod.render_labeled({"node": "n1", "worker": "w"}),
                    mod.render_labeled(None))
    assert out[tmetrics] == out[jmetrics]
    assert out[tmetrics][0].endswith("\n")


def test_reset_clears_registry_collectors_and_remote(clean):
    _mixed(tmetrics)
    tmetrics.reset()
    assert tmetrics.render_all() == "\n"
    assert tmetrics.snapshot() == {}


def _lint():
    spec = importlib.util.spec_from_file_location(
        "check_metrics_lint", ROOT / "scripts" / "check_metrics_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("catalog", [
    tengine.engine_metrics, tkv.kvcache_metrics, tspec.spec_metrics,
    tfault.fault_metrics, tdevmon.devmon_metrics, tzero.zero_metrics,
    tpipeline.pipeline_metrics],
    ids=lambda f: f.__name__)
def test_port_catalogs_pass_the_metric_lint(clean, catalog):
    """Each catalog registers the JAX package's series under the same
    names, kinds and tags, and passes scripts/check_metrics_lint.py."""
    import ray_tpu.llm.engine as jengine
    import ray_tpu.llm.kvcache as jkv
    import ray_tpu.llm.spec as jspec
    import ray_tpu.serve.fault as jfault
    import ray_tpu.train.pipeline as jpipeline
    import ray_tpu.train.zero as jzero
    import ray_tpu.util.devmon as jdevmon
    jax_catalog = {"engine_metrics": jengine.engine_metrics,
                   "kvcache_metrics": jkv.kvcache_metrics,
                   "spec_metrics": jspec.spec_metrics,
                   "fault_metrics": jfault.fault_metrics,
                   "devmon_metrics": jdevmon.devmon_metrics,
                   "zero_metrics": jzero.zero_metrics,
                   "pipeline_metrics": jpipeline.pipeline_metrics
                   }[catalog.__name__]
    got, want = catalog(), jax_catalog()
    assert _lint().lint({m.name: m for m in got.values()}) == []

    def shape(ms):
        return {k: (m.name, m.kind, m.tag_keys,
                    getattr(m, "boundaries", None)) for k, m in ms.items()}
    assert shape(got) == shape(want)


def test_push_once_and_push_loop_match_jax(clean, monkeypatch):
    """A worker's push: ``push_once`` sends this process's labelled
    samples as the JAX package's does (nothing when the registry is
    empty), and ``push_loop`` keeps pushing through a failed call."""
    import asyncio
    sent = {jmetrics: [], tmetrics: []}
    labels = {"node": "n1", "worker": "w"}

    async def drive(mod):
        async def call(method, **kw):
            sent[mod].append((method, kw))

        assert await mod.push_once(call, "worker:w", labels) is False
        _mixed(mod)
        assert await mod.push_once(call, "worker:w", labels) is True

    for mod in (jmetrics, tmetrics):
        asyncio.run(drive(mod))
    assert sent[tmetrics] == sent[jmetrics]
    assert [m for m, _ in sent[tmetrics]] == ["report_metrics"]

    calls = []
    real_sleep = asyncio.sleep

    async def no_wait(_s):
        await real_sleep(0)

    async def flaky(method, **kw):
        calls.append(method)
        if len(calls) == 1:
            raise ConnectionError("head briefly unreachable")

    async def loop():
        task = asyncio.ensure_future(
            tmetrics.push_loop(flaky, "worker:w", labels, interval_s=0.0))
        while len(calls) < 3:
            await real_sleep(0)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    monkeypatch.setattr(asyncio, "sleep", no_wait)
    asyncio.run(loop())
    assert calls[:3] == ["report_metrics"] * 3


def test_metrics_endpoint_is_not_ported(clean, monkeypatch):
    """The shared ``/metrics`` endpoint (``Config.metrics_port >= 0``):
    ``acquire_shared_server`` starts one ``MetricsServer`` per process,
    a second acquire returns its address, and a scrape renders the same
    Prometheus text as the JAX package's server for the same registry
    (exemplar tails stripped unless ``?exemplars=1``)."""
    import asyncio
    import urllib.request

    def scrape(addr, path="/metrics"):
        with urllib.request.urlopen(
                f"http://{addr[0]}:{addr[1]}{path}", timeout=10) as r:
            return r.read().decode()

    bodies = {}
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod, "_SRV", None)
        monkeypatch.setattr(mod, "_SRV_REFS", 0)
        _mixed(mod)

        async def go():
            addr = await mod.acquire_shared_server("127.0.0.1", 0)
            again = await mod.acquire_shared_server("127.0.0.1", 0)
            loop = asyncio.get_running_loop()
            out = [await loop.run_in_executor(None, scrape, addr),
                   await loop.run_in_executor(
                       None, scrape, addr, "/metrics?exemplars=1")]
            await mod.release_shared_server()
            return addr, again, out
        addr, again, bodies[mod] = asyncio.run(go())
        assert again == addr
    assert bodies[tmetrics] == bodies[jmetrics]