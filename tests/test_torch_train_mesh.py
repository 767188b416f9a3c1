"""The port's sharded train step (ray_tpu_torch/parallel/mesh.py
``make_train_step(cfg, mesh)``, models/llama.py over a ``MeshLlama``)
against the JAX package's GSPMD step on the same meshes.

The JAX step runs over the 8 virtual CPU devices (``mesh8``: fsdp 2,
tensor 2, context 2; and data 2, fsdp 2, tensor 2); the port's over eight
CPU stand-ins with the same axes, from the same parameters (the JAX
state's, bridged) on the same numpy batches, in f32. Tolerances:
- 3 steps' loss, grad norm and the final parameters: rtol 2e-4 and atol
  2e-4, the bar ``tests/test_model_llama.py`` holds the JAX sharded step
  to against one device (f32 sums over shards in other orders; observed
  a few 1e-6);
- losses of one model with and without a mesh: 1e-5 relative (the JAX
  tests' bar for the sharded fused CE), gradients 1e-5 of each tensor's
  largest entry;
- bitwise where the arithmetic is the same: a one-device mesh against
  ``mesh=None``, a state through numpy and back, pre-split batches
  against the same rows split by the step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.parallel import mesh as jmesh

from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import MeshSpec, make_mesh
from ray_tpu_torch.parallel import mesh as tmesh

MESHES = {"mesh8": dict(data=1, fsdp=2, tensor=2, context=2),
          "dp2": dict(data=2, fsdp=2, tensor=2, context=1)}
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def _mesh(kw):
    return make_mesh(MeshSpec(**kw), devices=("cpu",) * 8)


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _batch(seed, b=4, s=64, vocab=512, mask=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if mask is not None:
        batch["mask"] = mask
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state_tree(state, tcfg):
    """The port state's parameters as the JAX tree (via a Llama)."""
    params, _ = tmesh.state_to_numpy(state)
    model = tllama.empty_model(tcfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           params.items()})
    return bridge.params_to_numpy(model)


@pytest.mark.parametrize("name", list(MESHES))
def test_train_steps_match_jax(name, mesh8):
    """3 steps of the port's sharded step against JAX's on the same mesh:
    loss, grad norm and the final parameters."""
    jcfg, tcfg = jllama.tiny(dtype="float32"), tllama.tiny(dtype="float32")
    jm = mesh8 if name == "mesh8" else jmake_mesh(JMeshSpec(**MESHES[name]))
    j_init, j_step = jmesh.make_train_step(
        jcfg, jm, optimizer=jmesh.default_optimizer(**OPT))
    j_state = j_init(jax.random.PRNGKey(0))
    mesh = _mesh(MESHES[name])
    t_init, t_step = tmesh.make_train_step(
        tcfg, mesh, optimizer=tmesh.default_optimizer(**OPT))
    t_state = t_init(params=bridge.params_from_numpy(
        _tree_np(j_state.params), tcfg, "cpu", trainable=True))
    assert isinstance(t_state.params, tllama.MeshLlama)
    for i in range(3):
        batch = _batch(i)
        j_state, jm_ = j_step(j_state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        t_state, tm_ = t_step(t_state, batch)
        np.testing.assert_allclose(tm_["loss"].item(), float(jm_["loss"]),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tm_["grad_norm"].item(),
                                   float(jm_["grad_norm"]), rtol=2e-4,
                                   atol=2e-4)
    assert t_state.step == 3 and tm_["step"] == 3
    flat_w, tree_w = jax.tree.flatten(_tree_np(j_state.params))
    flat_g, tree_g = jax.tree.flatten(_state_tree(t_state, tcfg))
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def _sharded_loss(cfg, params_np, batch, mesh):
    model = bridge.params_from_numpy(params_np, cfg, "cpu", trainable=True)
    sm = tllama.shard_params_for_training(model, mesh)
    loss = tllama.loss_fn(sm, _torch(batch), cfg, mesh)
    loss.backward()
    return loss, sm.logical([p.grad for p in sm.parameters()])


def _single_loss(cfg, params_np, batch):
    model = bridge.params_from_numpy(params_np, cfg, "cpu", trainable=True)
    loss = tllama.loss_fn(model, _torch(batch), cfg)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def _close(got, want, rtol=1e-5):
    (lg, gg), (lw, gw) = got, want
    np.testing.assert_allclose(lg.item(), lw.item(), rtol=rtol)
    for n in gw:
        np.testing.assert_allclose(gg[n].numpy(), gw[n].numpy(), rtol=0,
                                   atol=1e-5 * gw[n].abs().max().item())


def test_fused_ce_sharded_matches(mesh8):
    """``ce_chunk > 0`` under mesh8 (the vocab over tensor, the sequence
    over context; ``tests/test_model_llama.py``'s sharded fused CE): the
    loss and gradients of the single-device classic path, and the JAX
    package's sharded fused loss."""
    base = dict(dtype="float32", logits_dtype="float32",
                attn_impl="reference", remat=False)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.tiny(**base))
    params = _tree_np(jparams)
    batch = _batch(2, b=2, s=256)
    want = jax.jit(lambda p, b: jllama.loss_fn(
        p, b, jllama.tiny(**base, ce_chunk=64), mesh8))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = _mesh(MESHES["mesh8"])
    fused = _sharded_loss(tllama.tiny(**base, ce_chunk=64), params, batch,
                          mesh)
    _close(fused, _single_loss(tllama.tiny(**base), params, batch))
    np.testing.assert_allclose(fused[0].item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="must divide seq len 256"):
        _sharded_loss(tllama.tiny(**base, ce_chunk=96), params, batch, mesh)
    # a chunk that divides the sequence (384) but not a context shard's
    # 192 positions: each shard's rows end in a shorter chunk
    batch = _batch(3, b=2, s=384)
    _close(_sharded_loss(tllama.tiny(**base, ce_chunk=128), params, batch,
                         mesh),
           _single_loss(tllama.tiny(**base), params, batch))


def test_forward_matches_jax_under_a_mesh(mesh8):
    """``forward_hidden`` and ``forward`` over mesh8 (the ring, the
    vocab-parallel lookup, the logits gathered over tensor) assemble the
    whole (b, s, ...) result, the JAX package's sharded forward's."""
    base = dict(dtype="float32")
    jcfg, tcfg = jllama.tiny(**base), tllama.tiny(**base)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _batch(5, b=2, s=128)["tokens"]
    want = jllama.forward(jparams, jnp.asarray(toks), jcfg, mesh8)
    mesh = _mesh(MESHES["mesh8"])
    sm = tllama.shard_params_for_training(
        bridge.params_from_numpy(_tree_np(jparams), tcfg, "cpu"), mesh,
        trainable=False)
    with torch.no_grad():
        got = tllama.forward(sm, torch.from_numpy(toks), tcfg, mesh)
        hidden = tllama.forward_hidden(sm, torch.from_numpy(toks), tcfg,
                                       mesh)
    assert got.shape == (2, 128, tcfg.vocab_size) and got.dtype == \
        torch.float32 and hidden.shape == (2, 128, tcfg.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ring_attention_in_model(mesh8):
    """attn_impl 'ring' and 'auto' (the ring under a context axis) agree
    with 'reference' (the gathered sequence) and with the JAX package's
    'ring' loss over mesh8; 'flash' is refused there as JAX refuses it."""
    base = dict(dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.tiny(**base))
    params = _tree_np(jparams)
    batch = _batch(1, b=2, s=128)
    want = jllama.loss_fn(jparams, {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                          jllama.tiny(**base, attn_impl="ring"), mesh8)
    mesh = _mesh(MESHES["mesh8"])
    ref = _sharded_loss(tllama.tiny(**base, attn_impl="reference"), params,
                        batch, mesh)
    for impl in ("ring", "auto"):
        got = _sharded_loss(tllama.tiny(**base, attn_impl=impl), params,
                            batch, mesh)
        _close(got, ref, rtol=1e-4)
        np.testing.assert_allclose(got[0].item(), float(want), rtol=1e-4)
    with pytest.raises(ValueError, match="cannot run under a "
                       "context-parallel mesh .context axis size 2.; use "
                       "'ring' or 'auto'"):
        _sharded_loss(tllama.tiny(**base, attn_impl="flash"), params, batch,
                      mesh)


@pytest.mark.parametrize("name", list(MESHES))
def test_uneven_mask_is_a_global_mean(name, mesh8):
    """A mask that leaves one shard's rows empty and the others uneven:
    the loss is the masked mean over the whole batch (JAX's), not a mean
    of per-shard means."""
    mask = np.ones((4, 64), np.float32)
    mask[0] = 0.0                    # row block 0: nothing
    mask[1, 5:] = 0.0
    mask[2, :50] = 0.0
    mask[3, ::3] = 0.0
    batch = _batch(7, mask=mask)
    base = dict(dtype="float32")
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.tiny(**base))
    jm = mesh8 if name == "mesh8" else jmake_mesh(JMeshSpec(**MESHES[name]))
    want = jllama.loss_fn(jparams, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jllama.tiny(**base), jm)
    params = _tree_np(jparams)
    got = _sharded_loss(tllama.tiny(**base), params, batch,
                        _mesh(MESHES[name]))
    _close(got, _single_loss(tllama.tiny(**base), params, batch))
    np.testing.assert_allclose(got[0].item(), float(want), rtol=1e-5)
    assert sorted(mask.sum(axis=1)) == [0.0, 5.0, 14.0, 42.0]


def test_mesh_state_round_trips_through_a_single_device_state():
    """``state_to_numpy`` of a mesh state gives the whole tensors under
    the single-device names: loaded into a single-device state it reads
    back the same, and loaded back into a fresh mesh state too, bitwise;
    the templates agree."""
    tcfg = tllama.tiny(dtype="bfloat16")
    mesh = _mesh(MESHES["mesh8"])
    init, step = tmesh.make_train_step(
        tcfg, mesh, optimizer=tmesh.default_optimizer(**OPT))
    state = init(torch.Generator().manual_seed(0))
    state, _ = step(state, _batch(0))
    params, opt = tmesh.state_to_numpy(state)
    s_init, _ = tmesh.make_train_step(tcfg, device="cpu")
    single = s_init(torch.Generator().manual_seed(5))
    tmp = tmesh.numpy_template(single)
    for a, b in ((tmp, (params, opt)), (tmesh.numpy_template(state),
                                        (params, opt))):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert x.shape == y.shape and x.dtype == y.dtype
    tmesh.state_from_numpy(single, params, opt)
    again = tmesh.state_to_numpy(single)
    fresh = init(torch.Generator().manual_seed(9))
    tmesh.state_from_numpy(fresh, *again)
    back = tmesh.state_to_numpy(fresh)
    for got in (again, back):
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves((params, opt))):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert fresh.step == 1 and fresh.opt_state.count == 1
    for p, q in zip(fresh.params.parameters(), state.params.parameters()):
        assert torch.equal(p, q)


def test_one_device_mesh_is_the_single_device_step():
    """A mesh of one device runs the single-device step, bit for bit:
    3 steps' metrics and the final parameters equal ``mesh=None``'s."""
    tcfg = tllama.tiny(dtype="float32")
    runs = []
    for mesh in (None, make_mesh(MeshSpec(fsdp=1), devices=("cpu",))):
        init, step = tmesh.make_train_step(
            tcfg, mesh, device="cpu" if mesh is None else None,
            optimizer=tmesh.default_optimizer(**OPT))
        state = init(torch.Generator().manual_seed(0))
        hist = []
        for i in range(3):
            state, m = step(state, _batch(i))
            hist.append((m["loss"].item(), m["grad_norm"].item()))
        runs.append((hist, [p.detach().clone()
                            for p in state.params.parameters()]))
        assert isinstance(state.params, tllama.Llama)
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_eval_step_and_remat_policies_under_a_mesh(monkeypatch):
    """``make_eval_step(cfg, mesh)`` gives the train step's loss without
    gradients; under (fsdp 2, tensor 2) K1 with lse (the op the selective
    policies save) runs once per shard and layer under "attn" and "dots"
    and twice under "full", and every policy gives the same gradients."""
    from ray_tpu_torch.ops import attention as TA
    mesh = make_mesh(MeshSpec(fsdp=2, tensor=2), devices=("cpu",) * 4)
    batch = _batch(4)
    grads = {}
    for policy, per in (("full", 2), ("attn", 1), ("dots", 1),
                        ("none", 1)):
        cfg = tllama.tiny(dtype="float32", remat_policy=policy)
        init, _ = tmesh.make_train_step(cfg, mesh)
        state = init(torch.Generator().manual_seed(0))
        loss = tmesh.make_eval_step(cfg, mesh)(state.params, batch)
        assert not loss.requires_grad
        before = TA.flash_fwd_lse.calls
        train_loss = tllama.loss_fn(state.params, batch, cfg, mesh)
        train_loss.backward()
        assert TA.flash_fwd_lse.calls - before == per * 4 * cfg.n_layers
        assert loss.item() == train_loss.item()
        grads[policy] = [p.grad for p in state.params.parameters()]
    for policy in ("attn", "dots", "none"):
        for a, b in zip(grads[policy], grads["full"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * b.abs().max().item())


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch as rt
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_dataset_shards_feed_sharded_train_step(cluster):
    """``tests/test_data_train_e2e.py``'s drive on the port:
    streaming_split shards -> ``iter_device_batches(sharding=mesh)``
    (each batch already split into every shard's blocks) -> the sharded
    step on (data 2, fsdp 2, tensor 2); the loss falls, and each step
    equals the same rows given whole, bit for bit."""
    from ray_tpu_torch import data as rt_data
    cfg = tllama.tiny(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_dim=128, dtype="float32",
                      logits_dtype="float32", attn_impl="reference")
    mesh = make_mesh(MeshSpec(data=2, fsdp=2, tensor=2, context=1),
                     devices=("cpu",) * 8)
    runs = []
    for whole in (False, True):
        init_fn, step_fn = tmesh.make_train_step(
            cfg, mesh, optimizer=tmesh.default_optimizer(
                learning_rate=1e-2, warmup_steps=1, total_steps=8))
        state = init_fn(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        rows = []
        for _ in range(64):
            t = rng.integers(1, 255, size=33).astype(np.int32)
            rows.append({"tokens": t[:-1], "targets": t[1:]})
        shards = rt_data.from_items(rows).streaming_split(2, equal=True)
        iters = [s.iter_device_batches(batch_size=4, sharding=mesh)
                 for s in shards]
        losses = []
        for _ in range(4):
            for it in iters:
                b = next(it)
                assert all(len(v) == mesh.size for v in b.values())
                assert b["tokens"][0].shape == (1, 32)
                if whole:
                    b = {k: torch.cat([v[mesh.index(dict(data=r // 2,
                                                         fsdp=r % 2))]
                                       for r in range(4)])
                         for k, v in b.items()}
                state, metrics = step_fn(state, b)
                losses.append(metrics["loss"].item())
        runs.append(losses)
    assert runs[0][-1] < runs[0][0], runs[0]
    assert runs[0] == runs[1]
    with pytest.raises(TypeError, match="DeviceMesh"):
        next(rt_data.range(8).iter_device_batches(batch_size=4,
                                                  sharding=object()))
