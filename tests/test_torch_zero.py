"""The port's gradient ring and ZeRO-1 held to the JAX package's.

- ``RingReducer`` over 3 ranks (one thread each, shm channels) and
  ``HierarchicalReducer`` over a 2x2 layout: ``reduce``,
  ``reduce_scatter`` and ``allgather`` of one pytree equal the JAX
  package's ring on the same values bitwise, in f32 and through the
  int8, int4 and bf16 wire codecs (both sides are numpy in the same
  order; the port's bf16 codec ships uint16 bits).
- The bf16 cast equals ml_dtypes' bitwise on its edge values: ties,
  subnormals, infinities, NaNs of either sign and payload, values that
  round to inf, and float64 inputs (only this test imports ml_dtypes);
  error feedback's codec round-trip equals the JAX package's bitwise.
- One ring round and one ZeRO step leave the same collective-ledger rows
  (group, kind, step, options-signature hash) on both packages.
- A tiny Llama on 2 ranks, 3 steps of ZeRO-1 over ``ShardAdamW`` with the
  global-norm clip active, against the JAX package's ``make_train_step``
  with its default optimizer on the concatenated batch: losses, grad
  norms and the final parameters within 2e-4 (the bar
  ``tests/test_torch_train_mesh.py`` holds a sharded step to).
- The same model through ``TorchTrainer(num_workers=2)`` on the CPU, with
  ``allreduce_gradients`` and the replicated AdamW (mode A) and with
  ``ShardedOptimizer`` (mode B): the trajectory equals one process's
  steps on the whole batch within 2e-4, and the ranks' grad norms and
  parameters are bitwise equal (read across ranks through the ring).
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.dag import channel as jchannel
from ray_tpu.dag import ring as jring
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec, make_mesh
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import zero as jzero
from ray_tpu.util import forensics as jforensics

import ray_tpu_torch
from ray_tpu_torch import bridge
from ray_tpu_torch.config import Config
from ray_tpu_torch.dag import channel as tchannel
from ray_tpu_torch.dag import ring as tring
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.train import zero as tzero
from ray_tpu_torch.util import forensics as tforensics

cloudpickle.register_pickle_by_value(sys.modules[__name__])

PKGS = {"jax": (jring, jchannel), "torch": (tring, tchannel)}
TOL = dict(rtol=2e-4, atol=2e-4)


def _all(reds, fn):
    with ThreadPoolExecutor(len(reds)) as ex:
        return list(ex.map(fn, reds))


def _flat_ring(pkg, n, **kw):
    ring, ch = PKGS[pkg]
    chans = [ch.ShmRingChannel(create=True, nslots=4, slot_bytes=1 << 16)
             for _ in range(n)]
    reds = [ring.RingReducer(chans[r], chans[(r - 1) % n], rank=r, size=n,
                             timeout_s=30, **kw) for r in range(n)]
    return reds, chans


def _hier_ring(pkg, counts, **inter_kw):
    ring, ch = PKGS[pkg]

    def mk():
        return ch.ShmRingChannel(create=True, nslots=4, slot_bytes=1 << 16)
    L = len(counts)
    intra_ch = {i: [mk() for _ in range(k)] for i, k in enumerate(counts)}
    inter_ch = [mk() for _ in range(L)]
    reds = []
    for i, k in enumerate(counts):
        for j in range(k):
            intra = ring.RingReducer(
                intra_ch[i][j], intra_ch[i][(j - 1) % k], rank=j, size=k,
                timeout_s=30, group=f"h.n{i}", level="intra")
            inter = ring.RingReducer(
                inter_ch[i], inter_ch[(i - 1) % L], rank=i, size=L,
                timeout_s=30, group="h.x", level="inter",
                **inter_kw) if j == 0 else None
            reds.append(ring.HierarchicalReducer(
                node=i, local=j, node_counts=counts, intra=intra,
                inter=inter, op="mean", timeout_s=30, group="h"))
    chans = [c for v in intra_ch.values() for c in v] + inter_ch
    return reds, chans


def _close(chans):
    for c in chans:
        c.close()
        c.unlink()


def _values(n):
    """Per-rank pytrees: a dict with a matrix, a vector and a list."""
    rng = np.random.default_rng(11)
    return [{"w": rng.standard_normal((37, 29)).astype(np.float32) * (r + 1),
             "b": rng.standard_normal(211).astype(np.float32),
             "l": [rng.standard_normal(5).astype(np.float32)]}
            for r in range(n)]


def _leaves(tree):
    out, _, _ = jring._flatten(tree)
    return out


def _run(pkg, make, n, kw):
    """Each rank's (reduce, reduce_scatter shard, allgather) results."""
    reds, chans = make(pkg)
    vals = _values(n)

    def one(red):
        r = vals[reds.index(red)]
        red_out = red.reduce(r, op="mean", **kw)
        shard = red.reduce_scatter(r, op="mean",
                                   **{k: v for k, v in kw.items()
                                      if k == "quantize"})
        gathered = red.allgather(shard, **{k: v for k, v in kw.items()
                                           if k == "wire_dtype"})
        return red_out, shard, gathered
    try:
        return _all(reds, one)
    finally:
        _close(chans)


CODECS = [{}, {"quantize": "int8"}, {"quantize": "int4"},
          {"wire_dtype": "bfloat16"}]


@pytest.mark.parametrize("kw", CODECS, ids=["f32", "int8", "int4", "bf16"])
@pytest.mark.parametrize("topo", ["flat3", "hier2x2"])
def test_ring_matches_jax_ring_bitwise(topo, kw):
    """reduce, reduce_scatter and allgather of one pytree: every rank's
    results equal the JAX package's ring's, bit for bit."""
    if topo == "flat3":
        def make(pkg):
            return _flat_ring(pkg, 3)
        n = 3
    else:
        def make(pkg):
            return _hier_ring(pkg, [2, 2])
        n = 4
    got = _run("torch", make, n, kw)
    want = _run("jax", make, n, kw)
    for (g_red, g_sh, g_ag), (w_red, w_sh, w_ag) in zip(got, want):
        for a, b in zip(_leaves(g_red) + [g_sh] + _leaves(g_ag),
                        _leaves(w_red) + [w_sh] + _leaves(w_ag)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for g in got[1:]:        # and identical on every rank
        for a, b in zip(_leaves(g[0]), _leaves(got[0][0])):
            assert np.array_equal(a, b)


def _edge_values() -> np.ndarray:
    f = np.float32
    one = f(1.0)
    ulp = f(2.0 ** -8)           # half a bf16 ulp at 1.0
    bits = np.array([0x00000001, 0x00008000, 0x00010000, 0x0000FFFF,
                     0x007FFFFF, 0x00800000, 0x00408000, 0x00418000,
                     0x7F7FFFFF, 0x7F7F7FFF, 0x7F7F8000, 0xFF7F8000,
                     0x7F800000, 0xFF800000, 0x7F800001, 0xFF800001,
                     0x7FC00000, 0xFFC00000, 0x7FBFFFFF, 0x7FFFFFFF,
                     0xFFFFFFFF, 0x80000000, 0x00000000, 0x3F808000,
                     0x3F818000, 0xBF808000, 0x3F807FFF, 0x3F808001],
                    np.uint32).view(np.float32)
    ties = np.array([one + ulp, one + 3 * ulp, -(one + ulp), 2 + 4 * ulp,
                     f(3.0e38), f(-3.4e38), f(1e-40), f(-1e-45)], f)
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64) \
        .astype(np.uint32).view(np.float32)
    return np.concatenate([bits, ties, rand])


def test_bf16_cast_matches_ml_dtypes_bitwise():
    x = _edge_values()
    with np.errstate(invalid="ignore", over="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        d = np.concatenate([x.astype(np.float64),
                            [1 + 2.0 ** -8 + 2.0 ** -40, 1e300, -1e-300]])
        want64 = d.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal(tring.bf16_bits(x), want)
    assert np.array_equal(tring.bf16_bits(d), want64)
    back = tring.bf16_values(want)
    ref = want.view(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(back.view(np.uint32), ref.view(np.uint32))
    finite = np.isfinite(x)
    assert np.array_equal(
        tring.wire_roundtrip(x[finite], tring.BFLOAT16),
        x[finite].astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_codec_roundtrip_matches_jax_bitwise(quantize):
    """The port computes error feedback's codec round-trip from the block
    scales without building frames; it equals the JAX package's
    decode(encode(x)) bit for bit: whole and ragged blocks, all-zero
    blocks, blocks holding inf or NaN, and the empty vector."""
    rng = np.random.default_rng(1)
    for n in (0, 1, 255, 256, 257, 4096, 100003):
        x = rng.standard_normal(n).astype(np.float32) * 5
        if n > 1000:
            x[256:512] = 0
            x[520], x[700] = np.inf, np.nan
        with np.errstate(invalid="ignore"):
            got = tring.codec_roundtrip(x, quantize)
            want = jring.codec_roundtrip(x, quantize)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _ledger_rows(led) -> list:
    return sorted((e["group"], e["kind"], e["step"], e["sig"])
                  for e in led.snapshot())


def test_ledger_rows_match_jax():
    """One allreduce round and one ZeRO step (optax's sgd on both
    sides, wrapped by each package's ShardedOptimizer over its ring):
    the collective ledgers hold the same rows."""
    import optax
    rows = {}
    for pkg, fx, zero in (("jax", jforensics, jzero),
                          ("torch", tforensics, tzero)):
        fx.ledger().clear()
        reds, chans = _flat_ring(pkg, 2, group="lg")
        vals = _values(2)
        params = {"w": np.ones(1000, np.float32)}

        def one(red):
            r = reds.index(red)
            red.reduce(vals[r], op="sum")
            so = zero.ShardedOptimizer(optax.sgd(0.1), group=red)
            st = so.init(params)
            return so.update({"w": np.full(1000, r + 1.0, np.float32)},
                             st, params)[0]["w"]
        try:
            out = _all(reds, one)
        finally:
            _close(chans)
        assert np.array_equal(out[0], out[1])
        rows[pkg] = _ledger_rows(fx.ledger())
    assert len(rows["torch"]) == 6      # 3 kinds x 2 ranks
    assert rows["torch"] == rows["jax"]
    assert all(r[3] for r in rows["torch"])    # every round signed


# --- a tiny Llama: ZeRO-1 on 2 ranks against the JAX make_train_step ------

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
           grad_clip=0.25)
STEPS = 3


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 512, (4, 33)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _half(batch, rank):
    return {k: torch.from_numpy(np.ascontiguousarray(v[2 * rank:
                                                       2 * rank + 2]))
            for k, v in batch.items()}


def _zero_rank(red, tcfg, params_np, batches):
    """One rank's 3 ZeRO-1 steps: (losses, grad norms, parameters)."""
    from ray_tpu_torch.parallel import ShardAdamW
    model = bridge.params_from_numpy(params_np, tcfg, "cpu", trainable=True)
    params = list(model.parameters())
    so = tzero.ShardedOptimizer(ShardAdamW(
        tmesh.default_optimizer(**OPT), device="cpu"), group=red)
    state = so.init([p.detach() for p in params])
    losses, norms = [], []
    for batch in batches:
        for p in params:
            p.grad = None
        loss = tllama.loss_fn(model, _half(batch, red.rank), tcfg)
        loss.backward()
        new, state = so.update([p.grad for p in params], state,
                               [p.detach() for p in params])
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        losses.append(loss.item())
        norms.append(so.grad_norm)
    return losses, norms, [p.detach().numpy().copy() for p in params]


def test_zero_trajectory_matches_jax_make_train_step():
    jcfg = jllama.tiny(dtype="float32", n_layers=2)
    tcfg = tllama.tiny(dtype="float32", n_layers=2)
    mesh = make_mesh(MeshSpec(data=1, fsdp=1, tensor=1, context=1),
                     devices=jax.devices()[:1])
    j_init, j_step = jmesh.make_train_step(
        jcfg, mesh, optimizer=jmesh.default_optimizer(**OPT))
    j_state = j_init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             j_state.params)
    batches = _batches()
    j_hist = []
    for batch in batches:
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        j_hist.append((float(jm["loss"]), float(jm["grad_norm"])))
    assert all(n > OPT["grad_clip"] for _, n in j_hist)   # the clip acts
    reds, chans = _flat_ring("torch", 2)
    try:
        out = _all(reds, lambda red: _zero_rank(red, tcfg, params_np,
                                                batches))
    finally:
        _close(chans)
    losses = np.mean([o[0] for o in out], axis=0)
    np.testing.assert_allclose(losses, [h[0] for h in j_hist], **TOL)
    assert out[0][1] == out[1][1]           # one norm, bitwise, per step
    np.testing.assert_allclose(out[0][1], [h[1] for h in j_hist], **TOL)
    for a, b in zip(out[0][2], out[1][2]):  # the ranks agree bitwise
        assert np.array_equal(a, b)
    want = bridge.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), j_state.params),
        tcfg, "cpu")
    for got, w in zip(out[0][2], want.parameters()):
        np.testing.assert_allclose(got, w.detach().numpy(), **TOL)


# --- the same through TorchTrainer(num_workers=2) -------------------------


def _tiny():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    cfg = llama.tiny(dtype="float32", n_layers=2, remat_policy="dots")
    init_fn, step_fn = mesh.make_train_step(
        cfg, device="cpu", optimizer=mesh.default_optimizer(**OPT))
    return cfg, init_fn(torch.Generator().manual_seed(0)), step_fn


def dp_train_fn(config):
    """One worker's steps on its half of each batch, syncing gradients by
    ``allreduce_gradients`` + the replicated AdamW ("A") or by
    ``ShardedOptimizer`` over ``ShardAdamW`` ("B")."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import ShardAdamW, mesh
    cfg, state, _ = _tiny()
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    params = list(state.params.parameters())
    opt = mesh.default_optimizer(**OPT)
    so = tzero.ShardedOptimizer(ShardAdamW(opt, device="cpu")) \
        if config["mode"] == "B" else None
    zstate = so.init([p.detach() for p in params]) if so else None
    for step, batch in enumerate(_batches()):
        for p in params:
            p.grad = None
        loss = llama.loss_fn(state.params, _half(batch, rank), cfg)
        loss.backward()
        grads = [p.grad for p in params]
        if so is None:
            grads = train.allreduce_gradients(grads, op="mean")
            gnorm = mesh.global_norm(grads)
            opt.update(state.opt_state, params, grads, gnorm)
            gnorm = gnorm.item()
        else:
            new, zstate = so.update(grads, zstate,
                                    [p.detach() for p in params])
            with torch.no_grad():
                for p, q in zip(params, new):
                    p.copy_(q)
            gnorm = so.grad_norm
        # what rank 1 saw reaches rank 0's report through the ring
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        seen = np.array([loss.item(), gnorm], np.float64)
        hi = train.allreduce_gradients([seen, flat], op="max")
        lo = train.allreduce_gradients([seen, flat], op="min")
        mean = train.allreduce_gradients(seen, op="mean")
        train.report({"step": step, "loss": float(mean[0]),
                      "grad_norm": gnorm, "rank": rank,
                      "same_norm": bool(hi[0][1] == lo[0][1]),
                      "same_params": bool(torch.equal(hi[1], lo[1]))})


@pytest.fixture(scope="module")
def cluster():
    cfg = Config.from_env(num_workers_prestart=0, max_workers_per_node=8,
                          default_max_task_retries=0)
    ray_tpu_torch.init(num_cpus=4, config=cfg)
    yield
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("mode", ["A", "B"])
def test_trainer_two_workers_match_one_process(cluster, mode):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    _, state, step_fn = _tiny()
    want = []
    for batch in _batches():
        state, m = step_fn(state, batch)
        want.append((m["loss"].item(), m["grad_norm"].item()))
    res = TorchTrainer(dp_train_fn, train_loop_config={"mode": mode},
                       scaling_config=ScalingConfig(num_workers=2)).fit()
    assert res.error is None, res.error
    rows = res.metrics_history              # rank 0's reports
    assert [(r["step"], r["rank"]) for r in rows] == \
        [(s, 0) for s in range(STEPS)]
    for r, (loss, gnorm) in zip(rows, want):
        np.testing.assert_allclose(r["loss"], loss, **TOL)
        np.testing.assert_allclose(r["grad_norm"], gnorm, **TOL)
        assert r["same_norm"] and r["same_params"]   # bitwise on both
