"""The port's in-place elastic reshape held to the JAX package, on the CPU.

- A tiny Llama trained by ``TorchTrainer(num_workers=(2, 3))`` with
  ``ShardedOptimizer(ShardAdamW(device="cpu"), mirror_interval_steps=1)``:
  rank 2 is SIGKILLed after its backward at step 3 of 6, the survivors
  catch ``PeerLostError``, ``await_regroup``, ``reshard`` and retry the
  step on their new slices of the batch. The 6 losses and grad norms
  match the JAX package's ``make_train_step`` on the whole batch within
  2e-4 (the bar ``tests/test_torch_zero.py`` holds ZeRO-1 to), worlds
  ``[3, 3, 3, 2, 2, 2]``, generation 1.
- A 3 -> 2 reshard of ShardAdamW states (``tests/_torch_reshape.py``):
  the survivors' new shards, concatenated, are bitwise the old three.
- A peer-mirror blob taken at step k keeps its bits after step k+1, and
  the update leaves the state it was given as it was.
- Without a covering mirror ``reshard`` raises ``ReshardError``, and in a
  trainer the controller then restores the group from its checkpoint.
- ``apply_rewire`` wakes a survivor blocked in a reduce-scatter on a dead
  neighbour with ``PeerLostError`` in well under a second of a 60 s ring
  timeout.
"""

import os
import pickle
import sys
import threading
import time
import uuid

import cloudpickle
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec, make_mesh
from ray_tpu.parallel import mesh as jmesh

import _torch_reshape
import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.config import Config
from ray_tpu_torch.parallel import ShardAdamW, default_optimizer
from ray_tpu_torch.train import reshard as treshard
from ray_tpu_torch.train.api import (FailureConfig, RunConfig,
                                     ScalingConfig, TrainContext,
                                     set_context)
from ray_tpu_torch.train.zero import ShardedOptimizer

cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(_torch_reshape)

TOL = dict(rtol=2e-4, atol=2e-4)
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
           grad_clip=0.25)
STEPS, DIE_AT, ROWS = 6, 3, 6     # ROWS splits over 3 ranks and over 2


@pytest.fixture
def cluster():
    cfg = Config.from_env(num_workers_prestart=0, max_workers_per_node=8,
                          default_max_task_retries=0)
    ray_tpu_torch.init(num_cpus=6, config=cfg)
    yield
    ray_tpu_torch.shutdown()


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 512, (ROWS, 33)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def elastic_fn(config):
    """Each worker's loop: this rank's slice of the batch at the current
    world size, one ZeRO-1 step, the loss averaged over the ring; rank 2
    of the first incarnation dies after its backward at DIE_AT, once its
    last mirror has landed."""
    import signal

    from ray_tpu_torch import bridge
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import ShardAdamW, mesh
    from ray_tpu_torch.train.zero import ShardedOptimizer
    torch.set_num_threads(1)
    cfg = llama.tiny(dtype="float32", n_layers=2)
    ctx = train.get_context()
    model = bridge.params_from_numpy(config["params"], cfg, "cpu",
                                     trainable=True)
    params = list(model.parameters())
    so = ShardedOptimizer(ShardAdamW(mesh.default_optimizer(**OPT),
                                     device="cpu"),
                          mirror_interval_steps=1)
    state = so.init([p.detach() for p in params])
    step = 0
    while step < STEPS:
        world, rank = ctx.get_world_size(), ctx.get_world_rank()
        rows = ROWS // world
        mine = {k: torch.from_numpy(np.ascontiguousarray(
                    v[rank * rows:(rank + 1) * rows]))
                for k, v in config["batches"][step].items()}
        for p in params:
            p.grad = None
        loss = llama.loss_fn(model, mine, cfg)
        loss.backward()
        if step == DIE_AT and rank == 2 and ctx.generation == 0:
            if not ctx.wait_mirror(timeout_s=30):
                raise RuntimeError("the step-2 mirror never landed")
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            new, state = so.update([p.grad for p in params], state,
                                   [p.detach() for p in params])
        except train.PeerLostError:
            train.await_regroup(timeout_s=60)
            state = so.reshard(state)
            continue                # retry the step on the new slices
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        mean = train.allreduce_gradients(
            np.array([loss.item()], np.float64), op="mean")
        train.report({"step": step, "loss": float(mean[0]),
                      "grad_norm": so.grad_norm, "world": world,
                      "generation": ctx.generation})
        step += 1


def test_zero_run_losing_rank_2_matches_jax_make_train_step(cluster):
    jcfg = jllama.tiny(dtype="float32", n_layers=2)
    mesh = make_mesh(MeshSpec(data=1, fsdp=1, tensor=1, context=1),
                     devices=jax.devices()[:1])
    j_init, j_step = jmesh.make_train_step(
        jcfg, mesh, optimizer=jmesh.default_optimizer(**OPT))
    j_state = j_init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             j_state.params)
    batches = _batches()
    want = []
    for batch in batches:
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
    res = train.TorchTrainer(
        elastic_fn,
        train_loop_config={"params": params_np, "batches": batches},
        scaling_config=ScalingConfig(num_workers=(2, 3),
                                     sync_timeout_s=60.0,
                                     elastic_grow_interval_s=0.0),
        run_config=RunConfig(
            failure_config=FailureConfig(max_failures=1))).fit()
    assert res.error is None, res.error
    hist = [m for m in res.metrics_history if "step" in m]
    assert [m["step"] for m in hist] == list(range(STEPS))
    assert [m["world"] for m in hist] == [3, 3, 3, 2, 2, 2]
    assert hist[-1]["generation"] == 1
    np.testing.assert_allclose([m["loss"] for m in hist],
                               [w[0] for w in want], **TOL)
    np.testing.assert_allclose([m["grad_norm"] for m in hist],
                               [w[1] for w in want], **TOL)


def test_reshard_3_to_2_is_pure_data_movement():
    old, new = _torch_reshape.reshape_3_to_2(mirror=True)
    _torch_reshape.check_bitwise(old, new)


def test_reshard_without_a_covering_mirror_raises():
    _, new = _torch_reshape.reshape_3_to_2(mirror=False)
    for got in new:
        assert isinstance(got, treshard.ReshardError), got
        assert "no surviving in-memory mirror" in str(got)


def test_mirror_blob_keeps_its_bits_after_the_next_step():
    """ShardAdamW's update is functional: the state of step k keeps its
    moments when step k+1 runs (a retried step, and the preemption
    mirror of the last completed step, read it), and a blob snapshotted
    at step k — a copy, never a view of a CPU tensor — keeps its bits,
    also after it crossed by pickle into a mapping of its own."""
    so = ShardedOptimizer(ShardAdamW(default_optimizer(1e-2,
                                                       warmup_steps=1,
                                                       total_steps=10),
                                     device="cpu"),
                          mirror_interval_steps=1)
    p = _torch_reshape.params()
    state = so.init(p)
    p, state = so.update(_torch_reshape.grads(0, 0), state, p)
    mu, nu = state.mu.clone(), state.nu.clone()
    blob = so._snapshot(state)
    crossed = pickle.loads(pickle.dumps(blob))
    assert blob["step"] == 1 and blob["bounds"] == (0, mu.numel())
    p, state2 = so.update(_torch_reshape.grads(1, 0), state, p)
    assert not torch.equal(state2.mu, mu)         # step k+1 moved on
    assert torch.equal(state.mu, mu) and torch.equal(state.nu, nu)
    assert so._last_state is state2
    for leaves in (blob["leaves"], crossed["leaves"]):
        assert np.array_equal(leaves[0].view(np.int32),
                              mu.numpy().view(np.int32))
        assert np.array_equal(leaves[1].view(np.int32),
                              nu.numpy().view(np.int32))


def test_rewire_wakes_a_blocked_reduce_scatter():
    """Rank 1 of a 2-ring stops after one round; rank 0's next ZeRO step
    blocks in the reduce-scatter. The controller's rewire (apply_rewire
    aborts the live ring) surfaces PeerLostError within ~0.25 s, not
    after the 60 s ring timeout."""
    gid = uuid.uuid4().hex
    specs = _torch_reshape.ring_specs(2, gid, timeout_s=60.0)
    ctxs = [TrainContext(r, 2, r, 0, None, group_id=gid,
                         grad_sync=specs[r]) for r in range(2)]
    opts = [ShardedOptimizer(ShardAdamW(default_optimizer(),
                                        device="cpu")) for _ in range(2)]
    out = {}
    first = threading.Barrier(2)

    def run(r):
        set_context(ctxs[r])
        p = _torch_reshape.params()
        state = opts[r].init(p)
        p, state = opts[r].update(_torch_reshape.grads(0, r), state, p)
        first.wait(timeout=30)
        if r == 1:
            return
        try:
            opts[r].update(_torch_reshape.grads(1, r), state, p)
        except train.PeerLostError as e:
            out["err"], out["t"] = e, time.monotonic()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    try:
        for t in threads:
            t.start()
        threads[1].join(timeout=30)
        time.sleep(1.0)             # rank 0 is inside the reduce-scatter
        assert threads[0].is_alive()
        t0 = time.monotonic()
        ctxs[0].apply_rewire({"rank": 0, "world_size": 1,
                              "group_id": uuid.uuid4().hex})
        threads[0].join(timeout=10)
        assert not threads[0].is_alive()
    finally:
        for c in ctxs:
            c.close_gradient_sync()
    assert "err" in out
    assert out["t"] - t0 < 2.0


DIM, LR = 12, 0.05


def _problem():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(32, DIM)).astype(np.float32)
    return X, (X @ np.linspace(-1.0, 1.0, DIM)).astype(np.float32)


def _loss_grad(w, X, y):
    r = X @ w - y
    return float(np.mean(r * r)), \
        ((2.0 / len(y)) * (X.T @ r)).astype(np.float32)


def _shard_adamw():
    return ShardAdamW(default_optimizer(LR, warmup_steps=1,
                                        total_steps=100), device="cpu")


def unmirrored_fn(config):
    """A ZeRO loop with no peer mirrors, checkpointing every step: the
    reshaped survivors' reshard must refuse, and the restart resumes
    from the checkpoint."""
    import signal

    from ray_tpu_torch.train import ckptio
    from ray_tpu_torch.train import reshard as rs
    ctx = train.get_context()
    X, y = _problem()
    params = {"w": np.zeros(DIM, np.float32)}
    so = ShardedOptimizer(_shard_adamw())
    state = so.init(params)
    ck = ckptio.AsyncCheckpointer()
    start = 0
    resume = ctx.get_checkpoint()
    if resume is not None:
        params, state, last = ckptio.restore(params, state,
                                             checkpoint=resume)
        start = last + 1
    step = start
    while step < STEPS:
        loss, g = _loss_grad(params["w"], X, y)
        if step == DIE_AT and ctx.get_world_rank() == 2 \
                and resume is None:
            time.sleep(0.5)             # the last reports land first
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            params, state = so.update({"w": g}, state, params)
        except train.PeerLostError:
            train.await_regroup(timeout_s=60)
            try:
                state = so.reshard(state)
            except rs.ReshardError:
                open(config["marker"], "w").close()
                raise
            continue
        ck.save(step, params, state, so, block=True)
        train.report({"step": step, "loss": loss, "resumed_from": start,
                      "world": ctx.get_world_size()})
        step += 1
        time.sleep(0.15)
    ck.close()


def test_unmirrored_loss_restores_from_checkpoint(cluster, tmp_path):
    X, y = _problem()
    so = ShardedOptimizer(_shard_adamw())
    params = {"w": np.zeros(DIM, np.float32)}
    state = so.init(params)
    want = []
    for _ in range(STEPS):
        loss, g = _loss_grad(params["w"], X, y)
        want.append(loss)
        params, state = so.update({"w": g}, state, params)
    marker = os.path.join(str(tmp_path), "reshard_refused")
    res = train.TorchTrainer(
        unmirrored_fn, train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=(2, 3),
                                     sync_timeout_s=60.0,
                                     elastic_grow_interval_s=0.0),
        run_config=RunConfig(
            storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1))).fit()
    assert res.error is None, res.error
    assert os.path.exists(marker), "no survivor's reshard refused"
    hist = [m for m in res.metrics_history if "step" in m]
    assert [m["step"] for m in hist] == list(range(STEPS))
    assert [m["resumed_from"] for m in hist[DIE_AT:]] == \
        [DIE_AT] * (STEPS - DIE_AT)
    np.testing.assert_allclose([m["loss"] for m in hist], want,
                               rtol=2e-3, atol=1e-4)
