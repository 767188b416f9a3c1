"""The port's request tracing (``util/tracing.py``'s request layer,
``util/events.py``, the engine's request and batch spans, tail-based
sampling) held to the JAX package's own tests.

``tests/test_zz_request_trace.py`` runs here through
``_torch_ported.py`` (``ray_tpu`` rewritten to ``ray_tpu_torch``). Its two
engine tests build their engine from a JAX model (the ``tiny_model``
fixture), so they are rewritten below on the port's ``Llama`` under the
same names and assertions, on the CPU (``device="cpu"``). Left out, each
naming the ROADMAP Queue 1 item it waits for: the three tests that call
``traces_from_events``/``summarize_traces`` and the metrics endpoint's
exemplar test (``MetricsServer``).
"""

import asyncio
import time

import pytest
import torch

from _torch_ported import adopt, ported
from ray_tpu_torch.util import events, tracing

_ITEM17 = ("waits for ROADMAP Queue 1 item 17 (the host-only util "
           "modules: {})")
adopt(ported("test_zz_request_trace"), globals(), skip={
    "test_finish_request_roots_only_sampled_traces":
        _ITEM17.format("traces_from_events"),
    "test_one_http_request_yields_a_cross_process_waterfall_e2e":
        _ITEM17.format("traces_from_events, summarize_traces"),
    "test_error_and_deadline_traces_survive_rate_zero_sampling_e2e":
        _ITEM17.format("summarize_traces"),
    "test_metrics_endpoint_strips_exemplars_unless_opted_in":
        _ITEM17.format("metrics.MetricsServer"),
    "test_engine_records_queue_prefill_generate_and_linked_batch_spans":
        "rewritten below on the port's Llama",
    "test_engine_failed_request_span_is_errored":
        "rewritten below on the port's Llama",
})


@pytest.fixture(scope="module")
def tiny_torch_model():
    from ray_tpu_torch.models import llama
    cfg = llama.tiny(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                     n_kv_heads=2, ffn_dim=64, dtype="float32",
                     logits_dtype="float32", attn_impl="reference")
    return cfg, llama.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")


def test_engine_records_queue_prefill_generate_and_linked_batch_spans(
        tiny_torch_model):
    from ray_tpu_torch.llm.engine import LLMEngine
    cfg, params = tiny_torch_model
    events.clear()
    t1 = "aa" * 16
    t2 = "bb" * 16

    async def go():
        eng = LLMEngine(cfg, params, max_slots=2, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        steps_per_sync=4, device="cpu")

        async def one(tid):
            tok = tracing.set_request_context(
                tracing.TraceContext(tid, tracing.new_span_id()))
            try:
                return await eng.generate([3, 5, 7],
                                          max_new_tokens=12)
            finally:
                tracing.reset_request_context(tok)

        await asyncio.gather(one(t1), one(t2))
        await eng.stop()

    asyncio.run(go())
    evs = [e for e in events.dump() if e.get("cat") == "request"]
    for tid in (t1, t2):
        segs = {e["seg"] for e in evs if e.get("trace") == tid}
        assert {"queue", "prefill", "generate"} <= segs, (tid, segs)
        gen = [e for e in evs if e.get("trace") == tid
               and e["seg"] == "generate"]
        assert len(gen) == 1 and gen[0]["tokens"] == 12
    batches = [e for e in evs if e.get("name") == "batch"]
    assert batches, "no decode block spans"
    linked = set()
    for b in batches:
        assert b["seg"] == "decode" and b["links"]
        linked.update(b["links"])
    assert linked == {t1, t2}
    # the TTFT histogram carries a trace-id exemplar for its bucket
    from ray_tpu_torch.util import metrics as m
    ttft = m._REGISTRY["llm_ttft_device_s"]
    assert any(x[0] in (t1, t2)
               for ex in ttft._exemplars.values() for x in ex.values())
    events.clear()


def test_engine_failed_request_span_is_errored(tiny_torch_model):
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.serve import fault
    cfg, params = tiny_torch_model
    events.clear()
    tid = "cd" * 16

    async def go():
        eng = LLMEngine(cfg, params, max_slots=1, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        device="cpu")
        tok = tracing.set_request_context(
            tracing.TraceContext(tid, tracing.new_span_id()))
        try:
            with pytest.raises(fault.DeadlineExceeded):
                await eng.generate([1, 2], max_new_tokens=4,
                                   deadline_ts=time.time() + 0.05)
        finally:
            tracing.reset_request_context(tok)
        await eng.stop()

    asyncio.run(go())
    gen = [e for e in events.dump() if e.get("cat") == "request"
           and e.get("trace") == tid and e.get("seg") == "generate"]
    assert len(gen) == 1 and gen[0]["error"]
    events.clear()
