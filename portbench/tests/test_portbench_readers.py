"""Each per-layer reader on a small synthetic trace."""

import json

import pytest

from portbench.bench import model as bm
from portbench.bench.manifest import Manifest
from portbench.bench.runner import read_per_layer, reader_context
from portbench.bench.trace import NothingToRead, Trace
from portbench.tests._tiny import ROOT
from portbench.work import attention as wa
from portbench.work import flops as wf

MAN = Manifest(ROOT)
PEAK = wa.PEAKS["bf16_flops_per_s"]
SPEC = bm.spec_from_config(json.loads(
    (ROOT / "portbench/configs/mistral-7b-v0.3.json").read_text()))
ATTN = dict(b=2, s=4096, h=32, kvh=8, d=128, itemsize=2, with_lse=True)
K1 = "void tc::flash_fwd_kernel_wgmma<128>(CUtensorMap_st)"
K2 = "void tc::flash_dkv_kernel_wgmma<128>(CUtensorMap_st)"
K3 = "void tc::flash_dq_kernel_wgmma<128>(CUtensorMap_st)"
K4 = "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128, 16>"
GEMM = "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT"


def read(metric, trace, run):
    return MAN.reader(metric)(reader_context(MAN, trace, run, SPEC, {}))


def train_trace():
    # one step: K1 twice, K2, K3 and a GEMM; 2 ms idle in a 12 ms window;
    # 3 ms of kernels under the optimizer range
    ops = [(K1, 0.0, 0.001), (K1, 0.001, 0.002), (K2, 0.002, 0.004),
           (K3, 0.004, 0.005), (GEMM, 0.005, 0.007),
           ("adam", 0.009, 0.012)]
    linked = [("adam", 0.003, ("aten::add_", "portbench.optimizer")),
              (GEMM, 0.002, ("aten::mm",))]
    return Trace(ops, linked, [("aten::mm", 0.0, 0.012)], 0.012)


def test_train_attn_roofline():
    want = (2 * wa.bound_s(wa.flash_fwd(**ATTN))
            + wa.bound_s(wa.flash_bwd_dkv(**ATTN))
            + wa.bound_s(wa.flash_bwd_dq(**ATTN))) / 0.005
    got = read("train_attn_roofline", train_trace(), {"attention": ATTN})
    assert got == pytest.approx(100 * want)


def test_train_optimizer_ms():
    got = read("train_optimizer_ms", train_trace(), {"traced_steps": 2})
    assert got == pytest.approx(1.5)


@pytest.mark.parametrize("metric", ["train_idle_share", "serve_idle_share"])
def test_idle_share(metric):
    assert read(metric, train_trace(), {}) == pytest.approx(
        100 * (1 - 0.010 / 0.012))


def test_train_mfu():
    run = {"tokens_per_s": 7000.0, "seq": 4096}
    assert read("train_mfu", train_trace(), run) == pytest.approx(
        100 * 7000.0 * wf.train_flops_per_token(SPEC, 4096) / PEAK)


def test_serve_readers():
    calls = [{"lengths": [100, 200, 1], "kvh": 8, "g": 4, "d": 128,
              "pool_itemsize": 2, "q_itemsize": 2},
             {"lengths": [101, 201, 2], "kvh": 8, "g": 4, "d": 128,
              "pool_itemsize": 2, "q_itemsize": 2}]
    trace = Trace([(K4, 0.0, 1e-5), (K4, 1e-5, 3e-5), (K4, 3e-5, 4e-5),
                   (GEMM, 4e-5, 1e-4)], [], [], 2e-4)
    run = {"decode_calls": calls, "window_s": 10.0, "window_flops": 2e15}
    mean = sum(wa.bound_s(wa.paged_decode(**c)) for c in calls) / 2
    assert read("decode_attn_roofline", trace, run) == pytest.approx(
        100 * 3 * mean / 4e-5)
    assert read("serve_mfu", trace, run) == pytest.approx(
        100 * 2e15 / 10.0 / PEAK)


CALL = {"lengths": [100], "kvh": 8, "g": 4, "d": 128, "pool_itemsize": 2,
        "q_itemsize": 2}
EMPTY = Trace([(GEMM, 0.0, 1e-3)], [], [], 1e-3)
NO_K2 = Trace([(K1, 0.0, 1e-3), (K3, 1e-3, 2e-3)], [], [], 2e-3)


@pytest.mark.parametrize("metric,trace,run,names", [
    ("train_attn_roofline", EMPTY, {"attention": ATTN}, "flash_fwd_kernel"),
    ("train_attn_roofline", NO_K2, {"attention": ATTN}, "flash_dkv_kernel"),
    ("train_optimizer_ms", EMPTY, {"traced_steps": 1}, "portbench.optimizer"),
    ("decode_attn_roofline", EMPTY, {"decode_calls": [CALL]},
     "paged_decode_kernel"),
    ("decode_attn_roofline", Trace([(K4, 0.0, 1e-5)], [], [], 1e-5),
     {"decode_calls": []}, "no decode-attention call"),
])
def test_a_layer_with_nothing_to_read_fails_by_name(metric, trace, run,
                                                    names):
    """A kernel set with an entry that matches nothing (one of K1-K3
    renamed, say), or a range that launched nothing, raises naming the
    entry: it never reads 0 or the share of the rest."""
    with pytest.raises(NothingToRead, match=names):
        read(metric, trace, run)


@pytest.mark.parametrize("metric", ["train_idle_share", "serve_idle_share"])
def test_idle_share_of_an_empty_window_is_nothing(metric):
    assert read(metric, Trace([], [], [], 1.0), {}) is None


def _cell_reading(cell, trace, run):
    return read_per_layer(MAN, cell, reader_context(MAN, trace, run, SPEC,
                                                    {}))


def test_a_listed_metric_that_reads_nothing_fails_the_run_with_its_layer(
        monkeypatch):
    run = {"attention": ATTN, "traced_steps": 1, "tokens_per_s": 7000.0,
           "seq": 4096}
    t = train_trace()
    no_k2 = Trace([op for op in t.device_ops if op[0] != K2], t.linked,
                  t.host_ops, t.window_s)
    with pytest.raises(RuntimeError, match=r"train_attn_roofline \(layer "
                       r"K1-K3 flash attention\).*flash_dkv_kernel"):
        _cell_reading("mistral7b.train.s4096", no_k2, run)
    real = MAN.reader
    monkeypatch.setattr(MAN, "reader", lambda name: (
        lambda ctx: None) if name == "train_idle_share" else real(name))
    with pytest.raises(RuntimeError, match=r"train_idle_share \(layer "
                       r"device\): its reader found nothing"):
        _cell_reading("mistral7b.train.s4096", t, run)


def test_a_sound_trace_reads_every_listed_metric():
    got = _cell_reading("mistral7b.train.s4096", train_trace(),
                        {"attention": ATTN, "traced_steps": 2,
                         "tokens_per_s": 7000.0, "seq": 4096})
    assert sorted(got) == sorted(m["name"] for m in
                                 MAN.per_layer("mistral7b.train.s4096"))


def test_busy_is_a_union_and_breakdown_lists_the_longest():
    t = Trace([("a", 0.0, 2.0), ("b", 1.0, 3.0), ("a", 5.0, 6.0)], [],
              [("aten::sync", 3.0, 5.0)], 7.0)
    assert t.busy_s() == pytest.approx(4.0)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["a", pytest.approx(3.0)]
    assert bd["idle_gaps"][0] == ["aten::sync", pytest.approx(2.0)]
    assert len(bd["idle_gaps"]) == 2
