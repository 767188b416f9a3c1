"""The port's MoE family (ray_tpu_torch/models/moe.py, the bridge's MoE
tree, ``make_train_step(cfg, model=moe)`` on one device and over an
expert mesh) against ``ray_tpu.models.moe``.

The same numpy-seeded inputs and the JAX state's parameters (bridged) go
through both, in f32 unless stated. Tolerances:
- routing: dispatch bitwise (the same top-k choices, ties to the lower
  expert on both sides, and the same integer positions), combine within
  1e-6 (the router's f32 softmax in another order), aux 1e-6 relative;
- forward logits and aux within 1e-5 of max|ref|; gradients within 1e-5
  of each tensor's largest entry (f32 sums in other orders: observed a
  few 1e-6); a bf16 forward within 5% of the logits' scale, the Llama
  tests' bar (both sides round every product to bf16 at other points);
- training: 3 steps' loss, grad norm and final parameters within rtol
  2e-4 and atol 2e-4, the bar of ``tests/test_torch_train_mesh.py``;
- expert meshes: losses within 1e-5 relative of the JAX package's on the
  same mesh (the reference's own test holds a sharded loss to one
  device's at 2e-2); bitwise where the arithmetic is the same (a state
  through numpy and back).

The seven tests of ``tests/test_model_moe.py`` (which imports jax and so
cannot be adopted) are rewritten here on torch under their names, with
their assertions; the two expert-mesh ones run on eight CPU stand-ins
(``devices=("cpu",) * 8``) for the JAX tests' virtual devices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import moe as jmoe
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.parallel import mesh as jmesh

from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe
from ray_tpu_torch.parallel import MeshSpec, make_mesh
from ray_tpu_torch.parallel import mesh as tmesh

OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
# the expert meshes of the parity tests (8 shards each); the context one
# runs a capacity small enough that tokens are dropped, so the row-global
# capacity positions and the global aux decide the loss
EXPERT_MESHES = {
    "dp2_fsdp2_ep2": (dict(data=2, fsdp=2, tensor=1, context=1, expert=2),
                      {}),
    "dp2_ep4": (dict(data=2, fsdp=1, tensor=1, context=1, expert=4), {}),
    "dp2_tp2_ep2": (dict(data=2, fsdp=1, tensor=2, context=1, expert=2),
                    {}),
    "fsdp2_cp2_ep2": (dict(data=1, fsdp=2, tensor=1, context=2, expert=2),
                      dict(capacity_factor=0.5)),
}


def _cfgs(**kw):
    base = dict(dtype="float32", attn_impl="reference")
    base.update(kw)
    return jmoe.tiny(**base), moe.tiny(**base)


def _cfg(**kw):
    return moe.tiny(attn_impl="reference", dtype="float32", **kw)


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _batch(seed, b=4, s=32, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _mesh(kw):
    return make_mesh(MeshSpec(**kw), devices=("cpu",) * 8)


def _model(jparams, tcfg, trainable=False):
    return bridge.moe_params_from_numpy(_tree_np(jparams), tcfg, "cpu",
                                        trainable=trainable)


# --- config and bridge ---------------------------------------------------------


def test_config_and_capacity_match_jax():
    """Every field, the capacity (rounded up to a multiple of 4, floor 4),
    the parameter counts and flops_per_token equal the JAX config's."""
    import dataclasses
    for kw in ({}, dict(capacity_factor=0.5), dict(n_experts=8,
                                                   experts_per_token=1)):
        jcfg, tcfg = jmoe.tiny(**kw), moe.tiny(**kw)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for s in (1, 2, 3, 7, 8, 13, 32, 100, 4096):
            assert tcfg.capacity(s) == jcfg.capacity(s), (kw, s)
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.num_active_params() == jcfg.num_active_params()
        assert tcfg.flops_per_token(64) == jcfg.flops_per_token(64)
    # both cases of the rounding are met by the tiny configs: the floor
    # (0 -> 4) and the round-up (6 -> 8)
    assert moe.tiny().capacity(1) == 4 and moe.tiny().capacity(10) == 8
    big = moe.mixtral_8x7b()
    assert dataclasses.asdict(big) == dataclasses.asdict(jmoe.mixtral_8x7b())
    assert big.capacity(4096) == 1280 and big.torch_dtype == torch.bfloat16


def test_bridge_round_trip_and_router_dtype():
    """The JAX tree through the bridge and back is exact, in f32 and in
    bf16 (the router crosses as f32 and stays f32); init_params draws
    every tensor at the JAX tree's shape and fan-in scale."""
    jcfg, tcfg = _cfgs(n_layers=3)
    tree = _tree_np(jmoe.init_params(jax.random.PRNGKey(0), jcfg))
    back = bridge.moe_params_to_numpy(bridge.moe_params_from_numpy(
        tree, tcfg, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = bridge.moe_params_from_numpy(tree, moe.tiny(n_layers=3), "cpu")
    assert bf.dtype == torch.bfloat16
    assert all(l.router.dtype == torch.float32 for l in bf.layers)
    np.testing.assert_array_equal(
        bridge.moe_params_to_numpy(bf)["layers"]["router"],
        tree["layers"]["router"])
    model = moe.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    got = bridge.moe_params_to_numpy(model)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, tree)
    assert sum(p.numel() for p in model.parameters()) == tcfg.num_params()
    for name, fan_in in (("w_gate", tcfg.dim), ("w_down", tcfg.ffn_dim),
                         ("router", tcfg.dim), ("wo", tcfg.dim)):
        std = got["layers"][name].std() * fan_in ** 0.5
        assert 0.9 < std < 1.1, (name, std)
    assert (got["layers"]["mlp_norm"] == 1).all()


# --- routing, forward, gradients against JAX --------------------------------------


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, dict(capacity_factor=0.5)),
                                     (2, dict(experts_per_token=1))])
def test_route_matches_jax(seed, kw):
    """``_route`` on a random y and router: dispatch bitwise, combine
    within 1e-6, aux within 1e-6 relative (with and without drops)."""
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((2, 32, tcfg.dim)).astype(np.float32)
    router = rng.standard_normal((tcfg.dim, tcfg.n_experts)).astype(
        np.float32)
    jd, jc, ja = jmoe._route(jnp.asarray(y), jnp.asarray(router), jcfg)
    td, tc, ta = moe._route(torch.from_numpy(y), torch.from_numpy(router),
                            tcfg)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    if kw.get("capacity_factor") == 0.5:      # this case drops tokens
        assert td.sum().item() < 2 * 32 * tcfg.experts_per_token


def test_top_k_breaks_ties_to_the_lower_expert():
    """Equal router probabilities pick the lower expert first, as
    ``lax.top_k`` does."""
    jcfg, tcfg = _cfgs()
    y = np.zeros((1, 8, tcfg.dim), np.float32)
    router = np.zeros((tcfg.dim, tcfg.n_experts), np.float32)
    jd, _, _ = jmoe._route(jnp.asarray(y), jnp.asarray(router), jcfg)
    td, _, _ = moe._route(torch.from_numpy(y), torch.from_numpy(router),
                          tcfg)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[0, :, :2].sum().item() == 16 and td[0, :, 2:].sum() == 0


@pytest.mark.parametrize("n_layers", [1, 2])
def test_forward_matches_jax(n_layers):
    """Logits and aux within 1e-5 of max|ref|."""
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    params = jmoe.init_params(jax.random.PRNGKey(n_layers), jcfg)
    toks = _batch(n_layers, b=2)["tokens"]
    jl, ja = jmoe.forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, ta = moe.forward(_model(params, tcfg), torch.from_numpy(toks))
    assert tl.shape == (2, 32, tcfg.vocab_size) and tl.dtype == torch.float32
    scale = np.abs(np.asarray(jl)).max()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=0,
                               atol=1e-5 * abs(float(ja)))


def test_forward_bf16_close_to_jax():
    """bf16 weights and activations (the router in f32 on both sides):
    the logits within 5% of their scale."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    params = jmoe.init_params(jax.random.PRNGKey(3), jcfg)
    toks = _batch(3, b=1, s=24)["tokens"]
    jl, _ = jmoe.forward(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, _ = moe.forward(_model(params, tcfg), torch.from_numpy(toks))
    want = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("remat_policy", ["full", "dots", "none"])
def test_grads_match_jax(remat_policy):
    """Every tensor's gradient of ``loss_fn`` (the router and the three
    expert tensors included) against ``jax.grad``, within 1e-5 of the
    tensor's largest entry, under each remat policy."""
    jcfg, tcfg = _cfgs(remat_policy=remat_policy)
    params = jmoe.init_params(jax.random.PRNGKey(5), jcfg)
    batch = _batch(5, b=2)
    jloss, jg = jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, _jnp(batch), jcfg))(params)
    model = _model(params, tcfg, trainable=True)
    loss = moe.loss_fn(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    got = bridge.moe_grads_to_numpy(model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(
            _tree_np(jg))[0], jax.tree.leaves(got)):
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_train_steps_match_jax():
    """3 steps of ``make_train_step(cfg, model=moe)`` on one device
    against the JAX package's on a one-device mesh, with
    ``default_optimizer`` on both sides: loss, grad norm and the final
    parameters."""
    jcfg, tcfg = _cfgs()
    jm = jmake_mesh(JMeshSpec(data=1, fsdp=1, tensor=1, context=1),
                    devices=jax.devices()[:1])
    j_init, j_step = jmesh.make_train_step(
        jcfg, jm, optimizer=jmesh.default_optimizer(**OPT), model=jmoe)
    j_state = j_init(jax.random.PRNGKey(0))
    t_init, t_step = tmesh.make_train_step(
        tcfg, device="cpu", optimizer=tmesh.default_optimizer(**OPT),
        model=moe)
    t_state = t_init(params=_model(j_state.params, tcfg, trainable=True))
    for i in range(3):
        batch = _batch(i)
        j_state, jmt = j_step(j_state, _jnp(batch))
        t_state, tmt = t_step(t_state, _torch(batch))
        np.testing.assert_allclose(tmt["loss"].item(), float(jmt["loss"]),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tmt["grad_norm"].item(),
                                   float(jmt["grad_norm"]), rtol=2e-4,
                                   atol=2e-4)
    assert t_state.step == 3
    got = bridge.moe_params_to_numpy(t_state.params)
    for w, g in zip(jax.tree.leaves(_tree_np(j_state.params)),
                    jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


# --- tests/test_model_moe.py on torch --------------------------------------------


def test_forward_shapes_and_aux():
    cfg = _cfg()
    model = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(_batch(1, b=2)["tokens"])
    with torch.no_grad():
        logits, aux = moe.forward(model, tokens, cfg)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert logits.dtype == torch.float32
    aux = float(aux)
    assert np.isfinite(aux) and aux > 0.0


def test_route_respects_topk_and_capacity():
    cfg = _cfg()
    s, E, k = 32, cfg.n_experts, cfg.experts_per_token
    C = cfg.capacity(s)
    g = torch.Generator().manual_seed(2)
    y = torch.randn((2, s, cfg.dim), generator=g)
    router = torch.randn((cfg.dim, E), generator=g)
    dispatch, combine, aux = moe._route(y, router, cfg)
    d = dispatch.numpy()
    # each token occupies at most k slots, each slot at most once
    per_token = d.sum(axis=(2, 3))
    assert per_token.max() <= k + 1e-6
    # no expert column holds more than one token per capacity slot
    per_slot = d.sum(axis=1)            # (b, E, C)
    assert per_slot.max() <= 1 + 1e-6
    assert d.shape == (2, s, E, C)
    # combine weights live only where dispatch does
    c = combine.numpy()
    assert (c[d == 0] == 0).all()
    # gates on kept slots sum to <= 1 per token (== 1 when nothing dropped)
    assert c.sum(axis=(2, 3)).max() <= 1 + 1e-5


def test_balanced_router_keeps_all_tokens():
    # round-robin token->expert assignment fits within capacity exactly:
    # nothing is dropped when the load is balanced
    cfg = _cfg(experts_per_token=1)
    s, E = 64, cfg.n_experts
    # y rows one-hot on (token % E); router projects those dims to logits
    y = torch.nn.functional.one_hot(torch.arange(s) % E,
                                    cfg.dim).float()[None]   # (1, s, dim)
    router = torch.zeros((cfg.dim, E))
    router[:E, :E] = 10 * torch.eye(E)
    dispatch, combine, _ = moe._route(y, router, cfg)
    kept = float(dispatch.sum())
    assert kept == s  # every token kept
    # and the row-sum of combine is exactly 1 (single expert, no drops)
    np.testing.assert_allclose(combine.sum(dim=(2, 3)).numpy(), 1.0,
                               rtol=1e-5)


def test_grads_flow_to_experts_and_router():
    cfg = _cfg(n_layers=1)
    model = moe.init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                            trainable=True)
    tokens = torch.from_numpy(_batch(1, b=2)["tokens"])
    batch = {"tokens": tokens, "targets": tokens}
    moe.loss_fn(model, batch, cfg).backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        g = getattr(model.layers[0], name).grad
        assert torch.isfinite(g).all(), name
        assert g.abs().max() > 0, f"no gradient reached {name}"


@pytest.mark.parametrize("name", list(EXPERT_MESHES))
def test_expert_parallel_matches_single_device(name, mesh8):
    """The loss over an expert mesh equals one device's (the reference's
    2e-2) and the JAX package's loss on the same mesh of its virtual
    devices within 1e-5 relative; the gradients (assembled whole) equal
    one device's within 1e-5 of each tensor's largest entry."""
    del mesh8  # ensure the session platform is initialized
    kw, extra = EXPERT_MESHES[name]
    jcfg, tcfg = _cfgs(**extra)
    params = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(1)

    model = _model(params, tcfg, trainable=True)
    ref = moe.loss_fn(model, _torch(batch), tcfg)
    ref.backward()
    ref_g = {n: p.grad for n, p in model.named_parameters()}

    mesh = _mesh(kw)
    sm = moe.shard_params_for_training(_model(params, tcfg), mesh)
    sharded = moe.loss_fn(sm, _torch(batch), tcfg, mesh)
    sharded.backward()
    np.testing.assert_allclose(sharded.item(), ref.item(), rtol=2e-2)

    jm = jmake_mesh(JMeshSpec(**kw))
    with jm:
        want = float(jax.jit(lambda p, b: jmoe.loss_fn(p, b, jcfg, jm))(
            params, _jnp(batch)))
    np.testing.assert_allclose(sharded.item(), want, rtol=1e-5)
    got = sm.logical([p.grad for p in sm.parameters()])
    assert set(got) == set(ref_g)
    for n, g in ref_g.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * g.abs().max().item(),
                                   err_msg=n)


def test_moe_train_step_on_expert_mesh():
    mesh = _mesh(dict(data=2, fsdp=1, tensor=1, context=1, expert=4))
    jm = jmake_mesh(JMeshSpec(data=2, fsdp=1, tensor=1, context=1,
                              expert=4))
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jcfg, cfg = _cfgs()
    j_init, j_step = jmesh.make_train_step(
        jcfg, jm, model=jmoe, optimizer=jmesh.default_optimizer(**opt))
    init_fn, step_fn = tmesh.make_train_step(
        cfg, mesh, model=moe, optimizer=tmesh.default_optimizer(**opt))
    tokens = _batch(1)["tokens"]
    batch = {"tokens": tokens, "targets": tokens}
    with jm:
        j_state = j_init(jax.random.PRNGKey(0))
        state = init_fn(params=_model(j_state.params, cfg, trainable=True))
        losses, want = [], []
        for _ in range(3):
            state, metrics = step_fn(state, batch)
            j_state, jmt = j_step(j_state, _jnp(batch))
            losses.append(float(metrics["loss"]))
            want.append(float(jmt["loss"]))
    assert isinstance(state.params, moe.MeshMoE)
    assert int(state.step) == 3
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]  # optimizer is actually learning
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_active_params_smaller_than_total():
    cfg = moe.mixtral_8x7b()
    assert cfg.num_active_params() < 0.5 * cfg.num_params()
    assert cfg.flops_per_token(2048) < 6.5 * cfg.num_active_params()


# --- mesh training, state round trip, edge cases -----------------------------------


def test_mesh_train_steps_match_jax_and_round_trip(mesh8):
    """3 steps over (fsdp 2, tensor 2, expert 2) against the JAX
    package's step on the same mesh: loss, grad norm and the final
    parameters at 2e-4. The ``MeshMoE`` state through ``state_to_numpy``
    and back is bitwise, and restores into a single-device state."""
    del mesh8
    kw = dict(data=1, fsdp=2, tensor=2, context=1, expert=2)
    jcfg, tcfg = _cfgs()
    jm = jmake_mesh(JMeshSpec(**kw))
    j_init, j_step = jmesh.make_train_step(
        jcfg, jm, optimizer=jmesh.default_optimizer(**OPT), model=jmoe)
    j_state = j_init(jax.random.PRNGKey(0))
    mesh = _mesh(kw)
    t_init, t_step = tmesh.make_train_step(
        tcfg, mesh, optimizer=tmesh.default_optimizer(**OPT), model=moe)
    t_state = t_init(params=_model(j_state.params, tcfg, trainable=True))
    assert isinstance(t_state.params, moe.MeshMoE)
    for i in range(3):
        batch = _batch(i)
        j_state, jmt = j_step(j_state, _jnp(batch))
        t_state, tmt = t_step(t_state, batch)
        np.testing.assert_allclose(tmt["loss"].item(), float(jmt["loss"]),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(tmt["grad_norm"].item(),
                                   float(jmt["grad_norm"]), rtol=2e-4,
                                   atol=2e-4)
    params, opt = tmesh.state_to_numpy(t_state)
    whole = moe.empty_model(tcfg, "cpu")
    whole.load_state_dict({k: torch.from_numpy(v) for k, v in
                           params.items()})
    got = bridge.moe_params_to_numpy(whole)
    for w, g in zip(jax.tree.leaves(_tree_np(j_state.params)),
                    jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)

    fresh = t_init(params=_model(j_state.params, tcfg, trainable=True))
    tmesh.state_from_numpy(fresh, params, opt)
    p2, o2 = tmesh.state_to_numpy(fresh)
    for k in params:
        np.testing.assert_array_equal(p2[k], params[k])
        np.testing.assert_array_equal(o2["mu"][k], opt["mu"][k])
        np.testing.assert_array_equal(o2["nu"][k], opt["nu"][k])
    assert fresh.step == 3 and o2["count"] == opt["count"]

    s_init, s_step = tmesh.make_train_step(
        tcfg, device="cpu", optimizer=tmesh.default_optimizer(**OPT),
        model=moe)
    single = s_init(torch.Generator().manual_seed(1))
    tmesh.state_from_numpy(single, params, opt)
    assert single.params.layers[0].router.dtype == torch.float32
    _, m1 = s_step(single, _torch(_batch(3)))
    _, m2 = t_step(fresh, _batch(3))
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)


def test_expert_axis_on_a_llama_and_bad_splits():
    """``make_mesh`` takes an expert axis; a Llama over (data 2, fsdp 2,
    expert 2) is replicated over it and its loss and gradients equal
    those over (data 2, fsdp 2) within 1e-6 relative;
    ``shard_params_for_training`` names the axis that does not divide."""
    mesh = make_mesh(MeshSpec(data=2, fsdp=2, tensor=1, context=1,
                              expert=2), devices=("cpu",) * 8)
    assert mesh.shape["expert"] == 2
    base = dict(dtype="float32", attn_impl="reference", remat=False)
    cfg = tllama.tiny(**base)
    model = tllama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = _torch(_batch(4, s=64))
    out = []
    for m in (mesh, make_mesh(MeshSpec(data=2, fsdp=2, tensor=1, context=1),
                              devices=("cpu",) * 4)):
        sm = tllama.shard_params_for_training(model, m)
        loss = tllama.loss_fn(sm, batch, cfg, m)
        loss.backward()
        out.append((loss, sm.logical([p.grad for p in sm.parameters()])))
    (l8, g8), (l4, g4) = out
    np.testing.assert_allclose(l8.item(), l4.item(), rtol=1e-6)
    for n in g4:
        np.testing.assert_allclose(g8[n].numpy(), g4[n].numpy(), rtol=0,
                                   atol=1e-6 * g4[n].abs().max().item())
    tcfg = _cfg(n_experts=3)
    m = moe.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="n_experts=3 not divisible by the "
                       "mesh's expert size 2"):
        moe.shard_params_for_training(m, mesh)
    with pytest.raises(ValueError, match="n_kv_heads=2 not divisible by "
                       "the mesh's tensor size 4"):
        moe.shard_params_for_training(
            moe.init_params(torch.Generator().manual_seed(0), _cfg(), "cpu"),
            make_mesh(MeshSpec(data=1, fsdp=2, tensor=4),
                      devices=("cpu",) * 8))
