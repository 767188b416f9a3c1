"""The port's serve fault tolerance (``serve/chaos.py``'s injected
failures, ``serve/fault.py``'s deadlines, retries and circuit breakers,
the proxy's admission and shedding, ``@serve.batch``'s cancelled
waiters, draining) held to the JAX package's own tests, and the port's
engine held to the same deadline assertions.

``tests/test_zz_serve_chaos.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No other name is renamed. Its three engine tests
build a JAX model in their ``tiny_model`` fixture, so they are left out
and written anew below on the port's engine (``device="cpu"``), with the
same names and the same assertions:

- test_engine_deadline_cancel_reclaims_batch_slot,
- test_engine_rejects_expired_submission,
- test_engine_stream_deadline_cuts_mid_generation.
"""

import asyncio
import time

import pytest
import torch

from _torch_ported import adopt, ported
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve import fault

# The proxy binds an ephemeral port here: the JAX package's serve tests,
# which may run at the same time in another test worker, bind 8000.
serve_api.DEFAULT_HTTP_PORT = 0

pytestmark = pytest.mark.chaos

SKIP = {
    "test_engine_deadline_cancel_reclaims_batch_slot":
        "builds a JAX model; written anew below on the port's engine",
    "test_engine_rejects_expired_submission":
        "builds a JAX model; written anew below on the port's engine",
    "test_engine_stream_deadline_cuts_mid_generation":
        "builds a JAX model; written anew below on the port's engine",
}

_ref = ported("test_zz_serve_chaos")
del _ref.tiny_model     # the JAX fixture: only the skipped tests use it
adopt(_ref, globals(), skip=SKIP)


@pytest.fixture(scope="module")
def tiny_model():
    from ray_tpu_torch.models import llama
    cfg = llama.tiny(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, ffn_dim=128, dtype="float32",
                     logits_dtype="float32", attn_impl="reference")
    return cfg, llama.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")


def test_engine_deadline_cancel_reclaims_batch_slot(tiny_model):
    """A ONE-slot engine: a long request whose budget expires mid-
    generation is cancelled (typed DeadlineExceeded), its slot is
    reclaimed, and a queued request then runs to completion — plus a
    queued request whose budget dies while WAITING fails fast without
    ever being admitted."""
    from ray_tpu_torch.llm.engine import LLMEngine
    cfg, params = tiny_model

    async def go():
        eng = LLMEngine(cfg, params, max_slots=1, max_len=4096,
                        prefill_buckets=(8,), cache_dtype="float32",
                        steps_per_sync=4, device="cpu")
        long_req = asyncio.ensure_future(eng.generate(
            [3, 7, 11], max_new_tokens=3000,
            deadline_ts=time.time() + 0.4))
        await asyncio.sleep(0.05)
        # queued behind the long request with a budget that dies first
        doomed = asyncio.ensure_future(eng.generate(
            [5, 9], max_new_tokens=4,
            deadline_ts=time.time() + 0.05))
        # queued with no deadline: must run once the slot frees
        follow = asyncio.ensure_future(eng.generate(
            [2, 4, 6], max_new_tokens=4))
        with pytest.raises(fault.DeadlineExceeded):
            await doomed
        with pytest.raises(fault.DeadlineExceeded):
            await long_req
        out = await follow
        assert len(out["tokens"]) == 4
        assert eng._slots == [None]       # every slot reclaimed
        await eng.stop()

    asyncio.run(go())


def test_engine_rejects_expired_submission(tiny_model):
    from ray_tpu_torch.llm.engine import LLMEngine
    cfg, params = tiny_model

    async def go():
        eng = LLMEngine(cfg, params, max_slots=1, max_len=64,
                        prefill_buckets=(8,), cache_dtype="float32",
                        device="cpu")
        with pytest.raises(fault.DeadlineExceeded):
            await eng.generate([1, 2], max_new_tokens=4,
                               deadline_ts=time.time() - 1.0)
        await eng.stop()

    asyncio.run(go())


def test_engine_stream_deadline_cuts_mid_generation(tiny_model):
    from ray_tpu_torch.llm.engine import LLMEngine
    cfg, params = tiny_model

    async def go():
        eng = LLMEngine(cfg, params, max_slots=1, max_len=4096,
                        prefill_buckets=(8,), cache_dtype="float32",
                        steps_per_sync=4, device="cpu")
        got = []
        with pytest.raises(RuntimeError) as ei:
            async for tok in eng.generate_stream(
                    [3, 5], max_new_tokens=3000,
                    deadline_ts=time.time() + 0.4):
                got.append(tok)
        assert isinstance(ei.value, fault.DeadlineExceeded)
        assert 0 < len(got) < 3000        # produced some, then was cut
        assert eng._slots == [None]
        await eng.stop()

    asyncio.run(go())
