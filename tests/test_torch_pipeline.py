"""The port's pipeline parallelism (ray_tpu_torch/train/pipeline.py and
dag/runtime.py ``pipe_exec_loop``) held to the JAX package's.

``tests/test_zz_pipeline.py`` runs here (``_torch_ported.py``, every
``ray_tpu`` name rewritten to ``ray_tpu_torch``, no other rename): its
schedule units, the controller's reshape gate and the worker's pipeline
flag, the chrome lanes, ``trace_step``'s pull-in, the state summary, the
knob family and the metrics run unedited. Its tests whose stage
functions compute in ``jnp`` are left out of the adoption, each
"rewritten below with torch stage functions" under its own name and
with its assertions: the same weights and microbatches, made with numpy
from the same seeds, through torch stages on the CPU (the slow e2e keeps
its mark). Beyond them:

- the integer linear pipeline equals the JAX package's own pipeline,
  run in-process on threads over its ``wire_local`` with the same
  numpy data, bitwise, under ``1f1b`` and ``gpipe``;
- a tiny two-stage Llama (f32, 2 + 2 layers, the JAX package's seeded
  weights through ``bridge.py``) matches ``jax.grad`` of the JAX
  ``loss_fn`` averaged over the microbatches, with ``optax.sgd``, over
  3 steps within 2e-4 (the bar ``tests/test_torch_zero.py`` holds a
  sharded step to: two f32 paths summing in other orders);
- a ``Pipeline`` over the port's runtime (``init()``, two stage actors
  in their own processes): its steps equal the in-process run's, its
  ``save_checkpoint`` restores into two new actors whose next step over
  the host transport equals the first pipeline's bitwise, and
  ``teardown`` returns ``stage_stats``.
"""

import functools
import importlib.util
import os
import pathlib
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

from _torch_pipeline_stages import (SGD, llama_stage_fn,
                                    llama_stage_params)
from _torch_ported import adopt, ported

import ray_tpu_torch
from ray_tpu_torch.train import pipeline as pl

cloudpickle.register_pickle_by_value(sys.modules[__name__])

REWRITTEN = "rewritten below with torch stage functions"
SKIP = {name: REWRITTEN for name in (
    "test_two_stage_parity_float",
    "test_two_stage_parity_bitwise_exact_sums",
    "test_zero_composed_per_stage_ring",
    "test_stage_user_error_propagates",
    "test_stage_death_peer_lost_with_flight_path",
    "test_activation_refs_do_not_leak",
    "test_device_ship_falls_back_whole_on_unwalkable_container",
    "test_activation_ref_ttl_bounds_leaks",
    "test_stop_injection_unwedges_boundary_parked_stages",
    "test_pipeline_e2e_cluster")}

P = ported("test_zz_pipeline")
adopt(P, globals(), skip=SKIP)


def _jax_pipeline_tests():
    """The JAX package's own test module, loaded under another name:
    its ``_run_pipeline`` drives the JAX package's pipeline."""
    path = pathlib.Path(__file__).resolve().parent / "test_zz_pipeline.py"
    spec = importlib.util.spec_from_file_location("_jax_zz_pipeline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- torch stages over the reference's data --------------------------------


def _stage0(params, xy):
    x, y = xy
    return (x @ params, y)


def _stage1(params, hy):
    h, y = hy
    return torch.mean((h @ params - y) ** 2)


def _linear_stages(dtype=np.float32, integer=False):
    """The reference's weights (same seed, same draws) behind torch
    stage functions."""
    rng = np.random.default_rng(7)
    if integer:
        W0 = rng.integers(-2, 3, (8, 16)).astype(dtype)
        W1 = rng.integers(-2, 3, (16, 1)).astype(dtype)
    else:
        W0 = rng.standard_normal((8, 16)).astype(dtype) * .1
        W1 = rng.standard_normal((16, 1)).astype(dtype) * .1
    return (_stage0, W0), (_stage1, W1)


def _microbatches(M, integer=False, batch=4):
    """The reference's microbatches (same seed, same draws) as CPU
    tensors."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(M):
        if integer:
            x = rng.integers(-2, 3, (batch, 8)).astype(np.float32)
            y = rng.integers(-2, 3, (batch, 1)).astype(np.float32)
        else:
            x = rng.standard_normal((batch, 8)).astype(np.float32)
            y = rng.standard_normal((batch, 1)).astype(np.float32)
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    return out


def _adam(lr: float):
    """Adam for the per-stage ZeRO ring: ``ShardAdamW`` without decay,
    warmup or a reachable clip, on the CPU."""
    from ray_tpu_torch.parallel import ShardAdamW
    from ray_tpu_torch.parallel.mesh import AdamW
    return ShardAdamW(AdamW(learning_rate=lr, weight_decay=0.0,
                            warmup_steps=0, total_steps=1000,
                            grad_clip=1e30), device="cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _run_pipeline(stages, xs, steps, *, schedule="1f1b", replicas=1,
                  device=False, lr=0.5, timeout_s=30.0, optimizer=None,
                  zero=None):
    """The reference's in-process harness on the port: stage loops on
    threads over ``wire_local``'s shm channels."""
    from ray_tpu_torch.dag.channel import DATA, STOP
    from ray_tpu_torch.dag.runtime import pipe_exec_loop
    from ray_tpu_torch.runtime.serialization import loads_oob, serialize
    (f0, W0), (f1, W1) = stages
    M = len(xs)
    specs, inputs, res, chans = pl.wire_local(
        2, M, schedule=schedule, replicas=replicas, device=device,
        timeout_s=timeout_s)
    opt = optimizer or (lambda: SGD(lr))
    actors = [
        [pl.PipelineStageActor(f0, W0, optimizer=opt(), zero=zero,
                               device="cpu")
         for _ in range(replicas)],
        [pl.PipelineStageActor(f1, W1, optimizer=opt(), is_last=True,
                               zero=zero, device="cpu")
         for _ in range(replicas)]]
    threads = []
    for k in range(2):
        for j in range(replicas):
            t = threading.Thread(target=pipe_exec_loop,
                                 args=(actors[k][j], specs[k][j]),
                                 daemon=True)
            t.start()
            threads.append(t)
    losses = []
    try:
        for _ in range(steps):
            for j in range(replicas):
                for mb in xs[j::replicas]:
                    inputs[j].write(serialize(mb), DATA, timeout=10)
            step_losses = []
            for k in range(2):
                for j in range(replicas):
                    kind, payload = res[k][j].read_bytes(timeout_s)
                    body = loads_oob(payload)
                    if kind != DATA:
                        raise body if isinstance(body, BaseException) \
                            else RuntimeError(str(body))
                    if body["result"].get("loss") is not None:
                        step_losses.append(body["result"]["loss"])
            losses.append(float(np.mean(step_losses)))
    finally:
        try:
            for j in range(replicas):
                inputs[j].write(b"", STOP, timeout=5)
            deadline = time.monotonic() + 15
            for k in range(2):
                for j in range(replicas):
                    while time.monotonic() < deadline:
                        kind, _ = res[k][j].read_bytes(
                            max(0.1, deadline - time.monotonic()))
                        if kind == STOP:
                            break
        except Exception:
            pass
        for t in threads:
            t.join(timeout=10)
        for c in chans:
            c.close()
            try:
                c.unlink()
            except Exception:
                pass
    return actors, losses


# --- the reference's tests, on torch stages ----------------------------------


def test_two_stage_parity_float():
    stages = _linear_stages()
    xs = _microbatches(4)
    actors, losses = _run_pipeline(stages, xs, steps=3)
    ref = P._reference_params(P._linear_stages(), P._microbatches(4),
                              steps=3)
    np.testing.assert_allclose(_np(actors[0][0].get_params()),
                               np.asarray(ref[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(actors[1][0].get_params()),
                               np.asarray(ref[1]), rtol=1e-6, atol=1e-7)
    assert losses[-1] < losses[0]      # it actually trains


def test_two_stage_parity_bitwise_exact_sums():
    """Integer-valued fp32 data: every matmul/accumulation is exact, so
    the pipeline's chained per-stage backward must reproduce the
    composed single-process gradient BITWISE — and GPipe vs 1F1B
    (different backward accumulation order) must agree bitwise too."""
    stages = _linear_stages(integer=True)
    xs = _microbatches(4, integer=True)
    ref = P._reference_params(P._linear_stages(integer=True),
                              P._microbatches(4, integer=True), steps=1,
                              lr=0.125)
    for schedule in ("1f1b", "gpipe"):
        actors, _ = _run_pipeline(stages, xs, steps=1,
                                  schedule=schedule, lr=0.125)
        assert np.array_equal(_np(actors[0][0].get_params()),
                              np.asarray(ref[0])), schedule
        assert np.array_equal(_np(actors[1][0].get_params()),
                              np.asarray(ref[1])), schedule


def test_zero_composed_per_stage_ring():
    """replicas=2: microbatches round-robin across two chains and each
    stage's replica pair syncs through a per-stage ZeRO-1 ring
    (ShardedOptimizer over RingReducer) at step end — replicas stay
    bitwise identical (the allgather guarantee), and the loss falls."""
    stages = _linear_stages()
    xs = _microbatches(4)
    actors, losses = _run_pipeline(
        stages, xs, steps=3, replicas=2,
        optimizer=lambda: _adam(1e-2))
    for k in range(2):
        a = _np(actors[k][0].get_params())
        b = _np(actors[k][1].get_params())
        assert np.array_equal(a, b), f"stage {k} replicas diverged"
    assert losses[-1] < losses[0]
    # per-stage ring group ids derive from the pipeline group
    # (<gid>.z<k>) so trace_step's pgroup prefix pulls them in
    from ray_tpu_torch.train.zero import ShardedOptimizer
    assert isinstance(actors[0][0]._opt, ShardedOptimizer)
    assert actors[0][0]._zero_spec["group"].endswith(".z0")
    assert actors[1][1]._zero_spec["group"].endswith(".z1")


def test_stage_user_error_propagates():
    """A stage whose compute raises ships the ORIGINAL error to the
    driver (not a timeout) and terminates the whole pipeline."""
    (f0, W0), (_f1, W1) = _linear_stages()

    def bad_stage(params, hy):
        raise ValueError("injected stage failure")

    xs = _microbatches(2)
    with pytest.raises(ValueError, match="injected stage failure"):
        _run_pipeline(((f0, W0), (bad_stage, W1)), xs, steps=1,
                      timeout_s=15.0)


def test_stage_death_peer_lost_with_flight_path(tmp_path):
    """A dead peer (nobody ever writes the backward edge) surfaces as
    the typed train.PeerLostError within the pipeline step timeout,
    carrying the stage-side flight-recorder dump path — the same
    post-mortem contract the collective ring plane has."""
    from ray_tpu_torch.config import Config, get_config, set_config
    from ray_tpu_torch.dag.channel import DATA
    from ray_tpu_torch.dag.runtime import pipe_exec_loop
    from ray_tpu_torch.runtime.serialization import loads_oob, serialize
    from ray_tpu_torch.train.collective import PeerLostError
    old = get_config()
    set_config(Config(collective_flight_dir=str(tmp_path)))
    try:
        (f0, W0), _ = _linear_stages()
        specs, inputs, res, chans = pl.wire_local(2, 2, timeout_s=1.0)
        actor = pl.PipelineStageActor(f0, W0, device="cpu")
        t = threading.Thread(target=pipe_exec_loop,
                             args=(actor, specs[0][0]), daemon=True)
        t.start()
        try:
            for mb in _microbatches(2):
                inputs[0].write(serialize(mb), DATA, timeout=5)
            kind, payload = res[0][0].read_bytes(20)
            err = loads_oob(payload)
            assert kind != DATA
            assert isinstance(err, PeerLostError)
            assert err.flight_recorder_path
            assert os.path.exists(err.flight_recorder_path)
            assert "flight recorder" in str(err)
        finally:
            t.join(timeout=10)
            for c in chans:
                c.close()
                try:
                    c.unlink()
                except Exception:
                    pass
    finally:
        set_config(old)


def test_activation_refs_do_not_leak():
    """Device-path transport: after every step the producer's device
    store is back to its baseline — schedule-owned refs are freed as
    the consumer materializes them, so steady-state memory is
    O(in-flight microbatches), not O(steps)."""
    from ray_tpu_torch.runtime.device_store import _store
    stages = _linear_stages()
    xs = _microbatches(4)
    store = _store()
    base = store.live_count()
    actors, losses = _run_pipeline(stages, xs, steps=4, device=True)
    assert store.live_count() == base
    assert store.live_bytes() == 0 or store.live_count() == base
    # the transport actually ran (activation bytes were metered)
    from ray_tpu_torch.util import metrics as m
    assert sum(m._REGISTRY["pipeline_activation_bytes_total"]
               ._values.values()) > 0
    # parity holds through the ref transport
    ref = P._reference_params(P._linear_stages(), P._microbatches(4),
                              steps=4)
    np.testing.assert_allclose(_np(actors[0][0].get_params()),
                               np.asarray(ref[0]), rtol=1e-6, atol=1e-7)


def test_device_ship_falls_back_whole_on_unwalkable_container():
    """An exotic container (defaultdict) anywhere in the payload falls
    the WHOLE payload back to host staging and frees any refs already
    parked — a partial ship would strand tensors nobody can free."""
    import collections

    from ray_tpu_torch.dag.runtime import _ship_device_tree
    from ray_tpu_torch.runtime.device_store import _store
    store = _store()
    base = store.live_count()
    dd = collections.defaultdict(list)
    dd["h"] = torch.ones((4,))
    payload = {"pre": torch.ones((8,)), "weird": dd}
    out, nbytes = _ship_device_tree(payload, ttl_s=60.0)
    assert out is payload          # untouched: host staging handles it
    assert nbytes == 0
    assert store.live_count() == base   # the parked "pre" ref was freed


def test_activation_ref_ttl_bounds_leaks():
    """An abandoned ref (consumer died before resolving) expires at
    its TTL instead of pinning memory forever — the
    pipeline_activation_ttl_s backstop."""
    from ray_tpu_torch.runtime.device_store import _store, put_device
    store = _store()
    base = store.live_count()
    ref = put_device(torch.ones((4, 4)), ttl_s=0.05)
    assert store.live_count() == base + 1
    time.sleep(0.1)
    assert store.live_count() == base
    with pytest.raises(KeyError):
        ref.resolve()


def test_stop_injection_unwedges_boundary_parked_stages():
    """A stage dead at a step BOUNDARY can't relay STOP (shm edges
    carry no death signal; survivors park on their first recv retry) —
    Pipeline.teardown injects STOP directly on inter-stage in-edges.
    This exercises that mechanic: stages 1..2 of a 3-stage pipeline
    with stage 0 never started, unwedged by injected STOPs."""
    from ray_tpu_torch.dag.channel import STOP, attach_channel
    from ray_tpu_torch.dag.runtime import pipe_exec_loop
    (f0, W0), _ = _linear_stages()
    specs, inputs, res, chans = pl.wire_local(3, 2, timeout_s=0.5)
    actors = [pl.PipelineStageActor(f0, W0, device="cpu")
              for _ in range(2)]
    threads = []
    for k in (1, 2):
        t = threading.Thread(target=pipe_exec_loop,
                             args=(actors[k - 1], specs[k][0]),
                             daemon=True)
        t.start()
        threads.append(t)
    time.sleep(0.8)     # both readers are now parked at the boundary
    assert all(t.is_alive() for t in threads)
    for k in (1, 2):    # the teardown injection path
        ch = attach_channel(specs[k][0]["fwd_in"], "producer",
                            timeout=2.0)
        ch.write(b"", STOP, timeout=1.0)
        ch.close()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    for c in chans:
        c.close()
        try:
            c.unlink()
        except Exception:
            pass


def _tanh_stage0(params, xy):
    x, y = xy
    return (torch.tanh(x @ params), y)


@pytest.mark.slow
def test_pipeline_e2e_cluster():
    """Real cluster: two PipelineStageActor dag actors driven by the
    Pipeline handle through its own channel wiring (device-ref
    transport on), losses decrease, stage stats come back at
    teardown."""
    from ray_tpu_torch import train

    ray_tpu_torch.init(num_cpus=8)
    try:
        rng = np.random.default_rng(0)
        W0 = rng.standard_normal((8, 16)).astype(np.float32) * 0.1
        W1 = rng.standard_normal((16, 1)).astype(np.float32) * 0.1

        Stage = ray_tpu_torch.remote(train.PipelineStageActor)
        s0 = Stage.remote(_tanh_stage0, W0, optimizer=SGD(0.2),
                          device="cpu")
        s1 = Stage.remote(_stage1, W1, optimizer=SGD(0.2), is_last=True,
                          device="cpu")
        pipe = train.Pipeline([s0, s1], num_microbatches=4,
                              device=True, timeout_s=120.0)
        try:
            xs = [(rng.standard_normal((4, 8)).astype(np.float32),
                   rng.standard_normal((4, 1)).astype(np.float32))
                  for _ in range(4)]
            losses = []
            for _ in range(4):
                out = pipe.step(xs)
                assert out.loss is not None
                assert 0.0 <= out.bubble_fraction <= 1.0
                losses.append(out.loss)
            assert losses[-1] < losses[0]
        finally:
            pipe.teardown()
        assert pipe.stage_stats is not None
        stages = {r["stage"] for r in pipe.stage_stats}
        assert stages == {0, 1}
        assert all(r["steps"] == 4 for r in pipe.stage_stats)
    finally:
        ray_tpu_torch.shutdown()


# --- against the JAX package's own pipeline ----------------------------------


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_integer_pipeline_bitwise_equals_jax_pipeline(schedule):
    """The integer linear construction through both packages' pipelines
    (stage loops on threads over each package's ``wire_local``), from
    the same numpy data: parameters after two steps and the losses are
    equal bitwise."""
    J = _jax_pipeline_tests()
    jactors, jlosses = J._run_pipeline(
        J._linear_stages(integer=True), J._microbatches(4, integer=True),
        steps=2, schedule=schedule, lr=0.125)
    actors, losses = _run_pipeline(
        _linear_stages(integer=True), _microbatches(4, integer=True),
        steps=2, schedule=schedule, lr=0.125)
    for k in range(2):
        got = _np(actors[k][0].get_params())
        want = np.asarray(jactors[k][0].get_params())
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert losses == jlosses


# --- a tiny two-stage Llama against jax.grad ---------------------------------


LLAMA_TOL = dict(rtol=2e-4, atol=2e-4)


def _llama_setup():
    import jax

    from ray_tpu.models import llama as jllama

    from ray_tpu_torch import bridge
    from ray_tpu_torch.models import llama as tllama
    jcfg = jllama.tiny(dtype="float32", n_layers=4)
    tcfg = tllama.tiny(dtype="float32", n_layers=4)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), tcfg,
        "cpu")
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, tcfg.vocab_size, (1, 33)).astype(np.int32)
            for _ in range(4)]
    mbs = [(t[:, :-1], t[:, 1:]) for t in toks]
    return jcfg, tcfg, jparams, model, mbs


def test_tiny_llama_pipeline_matches_jax_grad():
    """2 + 2 layers of the tiny f32 Llama through the port's pipeline
    (1f1b, 4 microbatches, torch SGD) against the JAX package: per step,
    ``jax.grad`` of its ``loss_fn`` over each microbatch, summed and
    divided by 4, then ``optax.sgd``. Losses and every parameter after 3
    steps within 2e-4."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import llama as jllama
    jcfg, tcfg, jparams, model, mbs = _llama_setup()
    lr, steps = 0.5, 3
    stages = ((functools.partial(llama_stage_fn, tcfg, 2, True, False),
               llama_stage_params(model, 0, 2, True, False)),
              (functools.partial(llama_stage_fn, tcfg, 2, False, True),
               llama_stage_params(model, 2, 4, False, True)))
    xs = [(torch.from_numpy(t).long(), torch.from_numpy(y).long())
          for t, y in mbs]
    actors, losses = _run_pipeline(stages, xs, steps=steps, lr=lr)

    opt = optax.sgd(lr)
    p, st = jparams, opt.init(jparams)
    want = []
    grad_fn = jax.jit(jax.value_and_grad(jllama.loss_fn),
                      static_argnums=2)
    for _ in range(steps):
        acc, tot = None, 0.0
        for t, y in mbs:
            loss, g = grad_fn(p, {"tokens": jnp.asarray(t),
                                  "targets": jnp.asarray(y)}, jcfg)
            tot += float(loss)
            acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        want.append(tot / len(mbs))
        upd, st = opt.update(jax.tree.map(lambda a: a / len(mbs), acc),
                             st, p)
        p = optax.apply_updates(p, upd)
    np.testing.assert_allclose(losses, want, **LLAMA_TOL)
    assert losses[-1] < losses[0]
    got0, got1 = (actors[k][0].get_params() for k in range(2))
    np.testing.assert_allclose(_np(got0["embed.weight"]),
                               np.asarray(p["embed"]), **LLAMA_TOL)
    np.testing.assert_allclose(_np(got1["lm_head.weight"]).T,
                               np.asarray(p["lm_head"]), **LLAMA_TOL)
    np.testing.assert_allclose(_np(got1["final_norm"]),
                               np.asarray(p["final_norm"]), **LLAMA_TOL)
    for i in range(4):
        got = got0 if i < 2 else got1
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(
                _np(got[f"layers.{i % 2}.{name}.weight"]).T,
                np.asarray(p["layers"][name][i]), **LLAMA_TOL)
        for name in ("attn_norm", "mlp_norm"):
            np.testing.assert_allclose(
                _np(got[f"layers.{i % 2}.{name}"]),
                np.asarray(p["layers"][name][i]), **LLAMA_TOL)


# --- Pipeline over the port's runtime ----------------------------------------


def test_pipeline_over_runtime_matches_in_process(tmp_path):
    """``init()``, two ``PipelineStageActor`` actors in their own worker
    processes, ``Pipeline`` (device transport, 1f1b, 4 microbatches):
    3 steps whose losses and parameters equal the in-process run's, a
    ``save_checkpoint`` after step 2, ``teardown`` with ``stage_stats``
    (3 steps per stage); then two new actors from other weights,
    ``restore_checkpoint`` and step 3 over the host transport: its loss
    and both stages' parameters equal the first pipeline's step 3
    bitwise."""
    from ray_tpu_torch import train
    stages = _linear_stages()
    xs = _microbatches(4)
    _, want = _run_pipeline(stages, xs, steps=3, lr=0.5)
    want_actors, _ = _run_pipeline(stages, xs, steps=3, lr=0.5)
    (f0, W0), (f1, W1) = stages
    ray_tpu_torch.init(num_cpus=4)
    try:
        Stage = ray_tpu_torch.remote(max_concurrency=2)(
            train.PipelineStageActor)

        def stage_pair(scale):
            return [Stage.remote(f0, W0 * scale, optimizer=SGD(0.5),
                                 device="cpu"),
                    Stage.remote(f1, W1 * scale, optimizer=SGD(0.5),
                                 is_last=True, device="cpu")]
        actors = stage_pair(1.0)
        pipe = train.Pipeline(actors, num_microbatches=4, device=True,
                              timeout_s=60.0)
        try:
            losses = []
            for step in range(3):
                out = pipe.step(xs)
                assert 0.0 <= out.bubble_fraction <= 1.0
                losses.append(out.loss)
                if step == 1:
                    path = pipe.save_checkpoint(str(tmp_path), step=2)
            params_a = ray_tpu_torch.get(
                [a.get_params.remote() for a in actors], timeout=60)
        finally:
            pipe.teardown()
        assert losses == want
        for k in range(2):
            assert np.array_equal(_np(params_a[k]),
                                  _np(want_actors[k][0].get_params()))
        assert pipe.stage_stats is not None
        assert {r["stage"] for r in pipe.stage_stats} == {0, 1}
        assert all(r["steps"] == 3 for r in pipe.stage_stats)

        actors = stage_pair(3.0)
        pipe = train.Pipeline(actors, num_microbatches=4, device=False,
                              timeout_s=60.0)
        try:
            assert pipe.restore_checkpoint(path) == 2
            out = pipe.step(xs)
            params_b = ray_tpu_torch.get(
                [a.get_params.remote() for a in actors], timeout=60)
        finally:
            pipe.teardown()
        assert out.loss == losses[2]
        for k in range(2):
            assert np.array_equal(_np(params_b[k]), _np(params_a[k]))
        assert all(r["steps"] == 1 for r in pipe.stage_stats)
    finally:
        ray_tpu_torch.shutdown()
