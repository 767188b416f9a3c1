"""The port's device-resident tensor transport (ray_tpu_torch/runtime/
device_store.py) and the prefill->decode KV handoff by handle, against
the JAX package's (tests/test_device_transport.py).

Same process, a handle resolves to the parked tensor itself; across
processes, one fetch through the port's runtime moves the bytes (bf16
bit for bit) and the owner frees them on request; an unresolved handle
ages out. On a tiny f32 Llama with the JAX package's seeded weights
carried through the bridge, ``prefill(device=True)`` admitted by
``generate_prefilled`` gives the JAX package's stream on the same route
and the port's own ``generate``; the handles are freed at admit; and
the same handoff between two CPU actors, each in its own worker process,
gives the in-process stream and leaves both stores empty. Streams are
greedy token ids, compared exactly.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax

import ray_tpu_torch
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.llm.pd import PrefillEngine as JaxPrefill
from ray_tpu.models import llama as jllama
from ray_tpu.runtime.device_store import TensorRef as JaxTensorRef

from ray_tpu_torch import bridge
from ray_tpu_torch.config import Config
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.pd import PrefillEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.runtime import device_store as ds
from ray_tpu_torch.runtime.device_store import (TensorRef, get_device,
                                                put_device)

# tests/test_device_transport.py:72's model, engines and prompt, plus a
# prompt past the one bucket (chunked prefill)
ARGS = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, dtype="float32", logits_dtype="float32",
            attn_impl="reference")
PRE_KW = dict(prefill_buckets=(16,), max_len=64, cache_dtype="float32")
ENG_KW = dict(PRE_KW, max_slots=2, steps_per_sync=1)
PROMPTS = [[5, 9, 13], [int(t) for t in
                        np.random.default_rng(3).integers(1, 127, 40)]]
NEW = 12


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.tiny(**ARGS)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.tiny(**{k: v for k, v in ARGS.items()
                          if k != "logits_dtype"})
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return jcfg, params, tcfg, tree


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, config=Config.from_env(
        num_workers_prestart=0, default_max_task_retries=0))
    yield
    ray_tpu_torch.shutdown()


def test_same_process_zero_copy():
    """tests/test_device_transport.py:16 on the port: the handle
    resolves to the very tensor parked (also when its own device is
    asked for), another device gets a copy, and a freed handle raises
    KeyError."""
    t = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    ref = put_device(t)
    assert isinstance(ref, TensorRef)
    assert ref.shape == (32, 32) and ref.dtype == "float32"
    assert get_device(ref) is t
    assert get_device(ref, "cpu") is t
    other = get_device(ref, "meta")
    assert other is not t and other.device.type == "meta"
    assert ds._store().live_bytes() >= 32 * 32 * 4
    ref.free()
    with pytest.raises(KeyError):
        get_device(ref)


def test_handle_pickles_like_the_reference():
    """The port's TensorRef keeps the reference's fields and pickling."""
    import pickle
    assert TensorRef.__slots__ == JaxTensorRef.__slots__
    ref = TensorRef("ab" * 16, (2, 3), "bfloat16", "c" * 32, ("h", 1))
    back = pickle.loads(pickle.dumps(ref))
    assert [getattr(back, f) for f in TensorRef.__slots__] == \
        [getattr(ref, f) for f in TensorRef.__slots__]


def test_ttl_purge(monkeypatch):
    """An unresolved handle stops pinning its tensor once its TTL
    passes, and then resolves to KeyError."""
    now = [100.0]
    monkeypatch.setattr(ds.time, "monotonic", lambda: now[0])
    store = ds.DeviceStore(ttl_s=5.0)
    short = store.put(torch.zeros(4), ttl_s=1.0)
    long = store.put(torch.ones(8))
    assert store.stats() == {"live_count": 2, "live_bytes": 48}
    now[0] += 2.0
    assert store.stats() == {"live_count": 1, "live_bytes": 32}
    with pytest.raises(KeyError):
        store.get(short)
    assert torch.equal(store.get(long), torch.ones(8))
    now[0] += 4.0
    assert store.live_count() == 0


def _parked(seed):
    """The tensors a holder parks: f32 values and bf16 bits from a seed."""
    g = torch.Generator().manual_seed(seed)
    return (torch.arange(5000, dtype=torch.float32) * 2.0,
            torch.randn((3, 70, 2, 16), generator=g).to(torch.bfloat16))


def test_cross_process_fetch_and_free(cluster):
    """tests/test_device_transport.py:44 on the port: an actor parks
    tensors; the driver resolves the handles (one fetch RPC each) onto
    its device, f32 values equal and bf16 bit for bit, and frees them
    at the owner. ``device=None`` means the card, which this host lacks:
    that raises before any fetch."""
    @ray_tpu_torch.remote
    class Holder:
        def park(self, seed):
            import torch
            from ray_tpu_torch.runtime.device_store import put_device
            g = torch.Generator().manual_seed(seed)
            self.parked = (torch.arange(5000, dtype=torch.float32) * 2.0,
                           torch.randn((3, 70, 2, 16),
                                       generator=g).to(torch.bfloat16))
            return [put_device(t) for t in self.parked]

        def live(self):
            from ray_tpu_torch.runtime.device_store import _store
            return _store().stats()

    h = Holder.remote()
    refs = ray_tpu_torch.get(h.park.remote(7), timeout=120)
    assert all(isinstance(r, TensorRef) for r in refs)
    assert all(r.owner_proc != ds._PROC_ID for r in refs)
    assert [r.dtype for r in refs] == ["float32", "bfloat16"]
    want = _parked(7)
    assert ray_tpu_torch.get(h.live.remote(), timeout=60) == {
        "live_count": 2,
        "live_bytes": sum(t.numel() * t.element_size() for t in want)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            refs[0].resolve()
    got = [r.resolve("cpu") for r in refs]
    assert torch.equal(got[0], want[0])
    assert got[1].dtype == torch.bfloat16
    assert torch.equal(got[1].view(torch.int16), want[1].view(torch.int16))
    for r in refs:
        r.free()
    with pytest.raises(KeyError):
        refs[0].resolve("cpu")
    assert ray_tpu_torch.get(h.live.remote(), timeout=60)["live_count"] == 0
    ray_tpu_torch.kill(h)


def _jax_streams(jcfg, params):
    """The JAX package's own route (tests/test_device_transport.py:72):
    prefill(device=True) handles admitted by generate_prefilled."""
    pre = JaxPrefill(jcfg, params, **PRE_KW)
    eng = JaxEngine(jcfg, params, **ENG_KW)

    async def go():
        outs = []
        for p in PROMPTS:
            pay = pre.prefill(p, device=True)
            assert isinstance(pay["k"], JaxTensorRef)
            outs.append((await eng.generate_prefilled(
                p, pay, max_new_tokens=NEW, temperature=0.0))["tokens"])
        await eng.stop()
        return outs

    return asyncio.run(go())


def _port_streams(tcfg, model, kv_block_size, handles: bool):
    """The port's streams: admitted from prefill(device=True) handles,
    or (``handles=False``) from the engine's own prefill. Returns the
    streams and the engine's stats."""
    kw = dict(ENG_KW, kv_block_size=kv_block_size, device="cpu")
    pre = PrefillEngine(tcfg, model, device="cpu", **PRE_KW)
    eng = LLMEngine(tcfg, model, **kw)

    async def go():
        outs = []
        for p in PROMPTS:
            if not handles:
                out = await eng.generate(p, max_new_tokens=NEW)
            else:
                pay = pre.prefill(p, device=True)
                assert isinstance(pay["k"], TensorRef)
                assert pay["kv_dtype"] == "float32"
                parked = get_device(pay["k"])
                # the parked payload is a tensor on the engine's device,
                # not a host array
                assert isinstance(parked, torch.Tensor)
                assert parked.device == eng.device
                assert tuple(parked.shape) == pay["k"].shape
                out = await eng.generate_prefilled(p, pay,
                                                   max_new_tokens=NEW)
                # admit freed the parked KV (single-use handoff)
                for key in ("k", "v"):
                    with pytest.raises(KeyError):
                        get_device(pay[key])
            outs.append(out["tokens"])
        st = eng.stats
        await eng.stop()
        return outs, st

    return asyncio.run(go())


@pytest.mark.parametrize("kv_block_size", [16, 0],
                         ids=["paged", "monolithic"])
def test_pd_handoff_by_handle_matches_jax(models, kv_block_size):
    jcfg, params, tcfg, tree = models
    model = bridge.params_from_numpy(tree, tcfg, "cpu")
    live0 = ds._store().live_count()
    want = _jax_streams(jcfg, params)
    got, st = _port_streams(tcfg, model, kv_block_size, handles=True)
    own, _ = _port_streams(tcfg, model, kv_block_size, handles=False)
    assert got == want == own
    assert all(len(s) == NEW for s in got)
    # the shipped bytes: block-granular (16) f32 k and v of each prompt
    ship = [-(-len(p) // 16) * 16 for p in PROMPTS]
    per_pos = 2 * tcfg.n_layers * tcfg.n_kv_heads * tcfg.head_dim * 4
    assert st["handoff_bytes"] == per_pos * sum(ship)
    assert ds._store().live_count() == live0


def test_handoff_across_two_actors_matches_in_process(models, cluster):
    """The handoff as the serving path's disaggregated mode runs it: a
    prefill actor parks the KV behind handles, the driver forwards the
    prefill result's ObjectRef to a decode actor in another process, which
    fetches, admits and frees the handles. The streams equal the
    in-process handoff's, and both actors' stores end empty."""
    _, _, tcfg, tree = models
    model = bridge.params_from_numpy(tree, tcfg, "cpu")
    want, _ = _port_streams(tcfg, model, 16, handles=True)

    @ray_tpu_torch.remote
    class Prefill:
        def __init__(self, cfg, tree, kw):
            from ray_tpu_torch import bridge
            from ray_tpu_torch.llm.pd import PrefillEngine
            self.engine = PrefillEngine(
                cfg, bridge.params_from_numpy(tree, cfg, "cpu"),
                device="cpu", **kw)

        def prefill(self, tokens):
            return self.engine.prefill(tokens, device=True)

        def live(self):
            from ray_tpu_torch.runtime.device_store import _store
            return _store().live_count()

    @ray_tpu_torch.remote
    class Decode:
        def __init__(self, cfg, tree, kw):
            from ray_tpu_torch import bridge
            from ray_tpu_torch.llm.engine import LLMEngine
            self.engine = LLMEngine(
                cfg, bridge.params_from_numpy(tree, cfg, "cpu"),
                device="cpu", **kw)

        async def generate_prefilled(self, tokens, prefilled, n):
            import ray_tpu_torch
            from ray_tpu_torch.runtime.core import ObjectRef
            if isinstance(prefilled, ObjectRef):
                prefilled = await ray_tpu_torch.get_async(prefilled)
            out = await self.engine.generate_prefilled(
                tokens, prefilled, max_new_tokens=n)
            return out["tokens"]

        def live(self):
            from ray_tpu_torch.runtime.device_store import _store
            return _store().live_count(), self.engine.stats[
                "handoff_bytes"]

    pre = Prefill.remote(tcfg, tree, PRE_KW)
    dec = Decode.remote(tcfg, tree, dict(ENG_KW, kv_block_size=16))
    got = []
    for p in PROMPTS:
        pay_ref = pre.prefill.remote(p)
        got.append(ray_tpu_torch.get(
            dec.generate_prefilled.remote(p, pay_ref, NEW), timeout=180))
    assert got == want
    assert ray_tpu_torch.get(pre.live.remote(), timeout=60) == 0
    live, shipped = ray_tpu_torch.get(dec.live.remote(), timeout=60)
    per_pos = 2 * tcfg.n_layers * tcfg.n_kv_heads * tcfg.head_dim * 4
    assert live == 0
    assert shipped == per_pos * sum(-(-len(p) // 16) * 16 for p in PROMPTS)
    for a in (pre, dec):
        ray_tpu_torch.kill(a)

