"""The port's host-only libraries against the JAX package's, on the same
inputs, on the CPU.

- ``tune``: ``generate_variants`` over a seeded space of grid, uniform,
  log-uniform and choice entries (equal); ASHA's and PBT's decisions on
  one stream of reports, and TPE's suggestions after the same
  observations from the same seed (equal: the same Python and numpy
  draws on both sides).
- ``train.boosting``: trees and predictions on the same data, through
  each package's own cluster, within 1e-12 relative (float64 numpy on
  both sides, the same reductions; observed equal).
- ``util.state``'s goodput, trace and device views and
  ``util.forensics.audit`` over the same event and ledger lists (equal
  rows and findings).
- A Tune trainer trial over a tiny f32 Llama: the ``TorchTrainer``
  trial's reported losses and grad norms against the JAX
  ``make_train_step``'s for the same steps from the same (bridged)
  weights, at ``tests/test_torch_train.py``'s trajectory bars (loss
  1e-4, grad norm 5e-3 relative).
- ``LLMConfig.checkpoint``: a tiny model saved with the port's
  ``ckptio`` and restored through ``serve.llm._load_model`` gives the
  same greedy streams as the JAX engine over the same parameters carried
  through ``bridge.py`` (equal tokens).
"""

import asyncio
import copy
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu
from ray_tpu import tune as jtune
from ray_tpu.llm.engine import LLMEngine as JaxEngine
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec, make_mesh
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import boosting as jboost
from ray_tpu.tune import search as jsearch
from ray_tpu.util import forensics as jfx
from ray_tpu.util import state as jstate

import ray_tpu_torch
from ray_tpu_torch import bridge
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.train import boosting as tboost
from ray_tpu_torch.train import ckptio
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.util import forensics as tfx
from ray_tpu_torch.util import state as tstate

# the trainer trial's train_fn runs in a worker, rebuilt from its bytes
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _space(tune):
    return {"lr": tune.grid_search([0.1, 0.01, 0.001]),
            "wd": tune.uniform(0.0, 0.3),
            "eps": tune.loguniform(1e-8, 1e-4),
            "layers": tune.choice([2, 4, 8]),
            "warm": tune.randint(0, 10),
            "fixed": 7}


@pytest.mark.parametrize("num_samples,seed", [(1, 0), (3, 11)])
def test_generate_variants_match_jax(num_samples, seed):
    want = jsearch.generate_variants(_space(jtune), num_samples, seed)
    got = tsearch.generate_variants(_space(ttune), num_samples, seed)
    assert got == want and len(got) == 3 * num_samples


def _report_stream(seed, n_trials=6, steps=9):
    rng = np.random.default_rng(seed)
    slope = rng.uniform(0.1, 2.0, n_trials)
    out = []
    for t in range(1, steps + 1):
        for i in rng.permutation(n_trials):
            out.append((f"t{i}", {"training_iteration": t,
                                  "loss": float(slope[i] / t
                                                + rng.normal(0, 0.05))}))
    return out


def _decisions(sched, stream):
    out = []
    for tid, m in stream:
        d = sched.on_result(tid, m)
        out.append(d if isinstance(d, str) else
                   ("exploit", d.donor_id, sorted(d.config.items())))
    return out


def test_asha_decisions_match_jax():
    stream = _report_stream(3)
    kw = dict(metric="loss", mode="min", grace_period=1, max_t=9,
              reduction_factor=2)
    want = _decisions(jtune.ASHAScheduler(**kw), stream)
    got = _decisions(ttune.ASHAScheduler(**kw), stream)
    assert got == want and "STOP" in got


def test_pbt_decisions_match_jax():
    stream = _report_stream(4)
    out = {}
    for tune in (jtune, ttune):
        pbt = tune.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2,
            hyperparam_mutations={"lr": [0.1, 0.01, 0.001],
                                  "wd": [0.0, 0.1]},
            quantile_fraction=0.5, seed=5)
        for i in range(6):
            pbt.on_trial_start(f"t{i}", {"lr": 0.01, "wd": 0.0,
                                         "momentum": 0.9})
        out[tune] = _decisions(pbt, stream)
    assert out[ttune] == out[jtune]
    assert any(isinstance(d, tuple) for d in out[ttune])


@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_suggestions_match_jax(mode):
    def run(search):
        s = search.TPESearcher(n_initial=5, n_candidates=16, seed=7)
        s.set_search_properties("loss", mode, {
            "x": search.uniform(-5.0, 5.0),
            "lr": search.loguniform(1e-5, 1e-1),
            "arm": search.choice(["a", "b", "c"])})
        picks = []
        for i in range(20):
            c = s.suggest(f"t{i}")
            picks.append(c)
            s.on_trial_complete(f"t{i}", {"loss": (c["x"] - 1.0) ** 2 + (
                0.5 if c["arm"] == "b" else 0.0)})
        return picks
    assert run(tsearch) == run(jsearch)


def _boost(pkg, boosting, X, y, Xt, objective):
    pkg.init(num_cpus=4)
    try:
        res = boosting.BoostingTrainer(
            boosting.BoostingConfig(objective=objective, num_boost_round=8,
                                    max_depth=3, num_workers=2),
            (X, y)).fit()
    finally:
        pkg.shutdown()
    return res.model.to_state(), res.model.predict(Xt), res.metrics_history


@pytest.mark.parametrize("objective", ["reg:squarederror",
                                       "binary:logistic"])
def test_boosting_trees_and_predictions_match_jax(objective):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(600, 4))
    y = np.sin(X[:, 0]) + X[:, 1] * X[:, 2]
    if objective == "binary:logistic":
        y = (y > 0).astype(np.float64)
    Xt = rng.normal(size=(100, 4))
    jst, jpred, jhist = _boost(ray_tpu, jboost, X, y, Xt, objective)
    tst, tpred, thist = _boost(ray_tpu_torch, tboost, X, y, Xt, objective)
    assert jax.tree.structure(tst) == jax.tree.structure(jst)
    for a, b in zip(jax.tree.leaves(tst), jax.tree.leaves(jst)):
        if isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-12)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-12)
    assert [h["train_metric"] for h in thist] == pytest.approx(
        [h["train_metric"] for h in jhist], rel=1e-12)


def _events(seed):
    """One seeded event list: goodput step spans of three ranks, request
    spans of sampled and unsampled traces, device hbm/compile/storm
    events, and events of other categories the views must skip."""
    rng = np.random.default_rng(seed)
    evs = []
    for step in range(6):
        for rank in range(3):
            parts = rng.uniform(0.0, 0.05, 5)
            evs.append({"cat": "goodput", "name": "step", "rank": rank,
                        "step": step, "ts": 100.0 + step + rank * 0.01,
                        "wall_s": float(parts.sum() + 0.1),
                        "compute_s": 0.1, "comm_exposed_s": parts[0],
                        "bubble_s": parts[1], "ckpt_stall_s": parts[2],
                        "compile_s": parts[3], "idle_s": parts[4],
                        "mfu": float(rng.uniform(0.2, 0.6))})
    for i in range(5):
        tid = f"{i:02d}" * 16
        for comp in ("proxy", "handle", "replica", "engine"):
            evs.append({"cat": "request", "name": "span", "trace": tid,
                        "component": comp, "node": f"node{i % 2}abcdef",
                        "ts": 200.0 + i, "dur": float(rng.uniform(0, 1)),
                        "error": bool(i == 3 and comp == "replica")})
        if i != 4:            # trace 4 was sampled out: no root span
            evs.append({"cat": "request", "name": "span", "trace": tid,
                        "root": True, "component": "proxy",
                        "status": "error" if i == 3 else "ok",
                        "keep": "error" if i == 3 else "sampled",
                        "deployment": "app", "ts": 200.0 + i,
                        "dur": float(rng.uniform(1, 2))})
    evs.append({"cat": "request", "name": "batch", "links": ["00" * 16]})
    for i in range(4):
        evs.append({"cat": "device", "name": "hbm", "device": "cuda:0",
                    "node": "node0abcdef", "pid": 10 + i % 2,
                    "ts": 300.0 + i, "used": int(rng.integers(1, 1 << 30)),
                    "limit": 80 << 30, "peak": 1 << 30,
                    "duty": float(rng.uniform()), "source": "torch.cuda"})
        evs.append({"cat": "device", "name": "compile",
                    "fn": f"flash_{i % 2}.cu", "node": "node0abcdef",
                    "pid": 10, "ts": 310.0 + i,
                    "dur": float(rng.uniform(1, 20)),
                    "cache_hit": bool(i == 3)})
    evs.append({"cat": "device", "name": "recompile_storm", "fn": "f",
                "count": 9, "window_s": 60.0, "ts": 320.0})
    evs.append({"cat": "device_window", "name": "decode", "ts": 1.0})
    return evs


@pytest.mark.parametrize("seed", [0, 1])
def test_state_views_match_jax(seed):
    evs = _events(seed)
    for name in ("goodput_from_events", "traces_from_events",
                 "devices_from_events"):
        want = getattr(jstate, name)(copy.deepcopy(evs))
        got = getattr(tstate, name)(copy.deepcopy(evs))
        assert got == want and got, name
    rows = tstate.traces_from_events(evs)
    assert tstate.summarize_traces(rows) == jstate.summarize_traces(rows)
    rows = tstate.devices_from_events(evs)
    assert tstate.summarize_devices(rows) == jstate.summarize_devices(rows)


def _ledgers():
    """Four ranks' ledger snapshots: rank 3 never entered seq 5 of the
    ring (a stall) while ranks 0-2 wait in it; seq 2 of a ZeRO group
    disagrees on its codec on rank 1 (a desync)."""
    def entry(group, seq, state, codec=None, sig="s0", t=0.0):
        return {"group": group, "seq": seq, "kind": "allreduce",
                "op": "sum", "codec": codec, "sig": sig, "state": state,
                "bytes": 1024, "step": 7, "t_enter": t,
                "t_exit": None if state == "in_flight" else t + 0.1}
    out = {}
    for r in range(4):
        ents = [entry("ring/g1", s, "done", t=float(s)) for s in range(5)]
        if r < 3:
            ents.append(entry("ring/g1", 5, "in_flight", t=5.0))
        ents.append(entry("zero/g2", 2, "done",
                          codec="int8" if r == 1 else None,
                          sig="s1" if r == 1 else "s0", t=2.0))
        out[r] = {"rank": r, "now": 100.0, "meta": {}, "entries": ents,
                  "max_seq": {"ring/g1": 5 if r < 3 else 4, "zero/g2": 2}}
    return out


@pytest.mark.parametrize("timeout", [10.0, 1000.0])
def test_forensics_audit_matches_jax(timeout):
    led = _ledgers()
    want = jfx.audit(copy.deepcopy(led), stall_timeout_s=timeout)
    got = tfx.audit(copy.deepcopy(led), stall_timeout_s=timeout)
    assert got == want
    kinds = sorted(f["kind"] for f in got)
    assert "collective_desync" in kinds
    assert ("collective_stall" in kinds) == (timeout < 95.0)


# --- a trainer trial over a tiny f32 Llama ----------------------------------

TRIAL_STEPS = 4
TRIAL_OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)


def _trial_batch(step):
    toks = np.random.default_rng(500 + step).integers(0, 512, (2, 33))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def _trial_fn(config):
    """The trial's train_fn, in the train worker: the port's step on the
    bridged weights, one report per step."""
    import torch

    from ray_tpu_torch import bridge, train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh
    cfg = llama.tiny(dtype="float32")
    init_fn, step_fn = mesh.make_train_step(
        cfg, device="cpu", optimizer=mesh.default_optimizer(
            **dict(TRIAL_OPT, learning_rate=config["lr"])))
    state = init_fn(params=bridge.params_from_numpy(
        config["params"], cfg, "cpu", trainable=True))
    for step in range(TRIAL_STEPS):
        state, m = step_fn(state, {k: torch.from_numpy(v) for k, v in
                                   _trial_batch(step).items()})
        train.report({"loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item()})


def test_trainer_trial_matches_jax_make_train_step():
    jcfg = jllama.tiny(dtype="float32")
    mesh = make_mesh(MeshSpec(data=1, fsdp=1, tensor=1, context=1),
                     devices=jax.devices()[:1])
    j_init, j_step = jmesh.make_train_step(
        jcfg, mesh, optimizer=jmesh.default_optimizer(**TRIAL_OPT))
    j_state = j_init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        j_state.params)
    want = []
    for step in range(TRIAL_STEPS):
        j_state, m = j_step(j_state, {k: jnp.asarray(v) for k, v in
                                      _trial_batch(step).items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    ray_tpu_torch.init(num_cpus=4)
    try:
        grid = ttune.Tuner(
            TorchTrainer(_trial_fn, train_loop_config={"params": tree},
                         scaling_config=ScalingConfig(num_workers=1)),
            param_space={"lr": ttune.grid_search(
                [TRIAL_OPT["learning_rate"]])},
            tune_config=ttune.TuneConfig(metric="loss", mode="min")).fit()
    finally:
        ray_tpu_torch.shutdown()
    (res,) = list(grid)
    assert res.status == "TERMINATED", (res.status, res.error)
    got = [(r["loss"], r["grad_norm"]) for r in res.all_reports
           if "grad_norm" in r][:TRIAL_STEPS]
    assert len(got) == TRIAL_STEPS
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)


# --- serving a checkpoint -----------------------------------------------------

SERVE_KW = dict(max_slots=2, max_len=64, prefill_buckets=(16,),
                cache_dtype="float32", kv_block_size=8)
PROMPTS = [[int(x) for x in np.random.default_rng(s).integers(1, 127, n)]
           for s, n in ((20, 12), (21, 5))]


async def _streams(eng):
    outs = await asyncio.gather(*[eng.generate(p, max_new_tokens=10)
                                  for p in PROMPTS])
    await eng.stop()
    return [o["tokens"] for o in outs]


def test_checkpoint_served_greedy_streams_match_jax_engine(tmp_path):
    args = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, ffn_dim=128, dtype="float32",
                attn_impl="reference")
    jcfg, tcfg = jllama.tiny(**args), tllama.tiny(**args)
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    model = bridge.params_from_numpy(tree, tcfg, "cpu")
    ck = ckptio.AsyncCheckpointer(str(tmp_path))
    ck.save(9, {n: p.detach().numpy() for n, p in model.named_parameters()},
            block=True)
    path = ck.last_committed().path
    ck.close()
    cfg, served = tllm._load_model(tllm.LLMConfig(
        model=tcfg, checkpoint=path, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(served.parameters(),
                                                 model.parameters()))
    want = asyncio.run(_streams(JaxEngine(jcfg, params,
                                          kv_impl="paged_flash",
                                          **SERVE_KW)))
    got = asyncio.run(_streams(LLMEngine(cfg, served, device="cpu",
                                         **SERVE_KW)))
    assert got == want and all(len(s) == 10 for s in got)
