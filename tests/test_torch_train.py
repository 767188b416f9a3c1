"""The port's training step (ray_tpu_torch/models/llama.py losses,
ray_tpu_torch/parallel) against the JAX package.

The JAX package's seeded weights cross through the bridge; batches are
made with numpy from a seed and fed to both sides; everything runs in f32
on the CPU. Tolerances:
- ``loss_fn`` values: 1e-6 relative (one f32 reduction of ~100 terms in
  another order); per-leaf gradients: 2e-5 of the leaf's largest entry
  (two layers of f32 matmuls summed in other orders; observed 2e-6).
- the 20-step trajectory: loss 1e-4 and grad norm 5e-3 relative. Adam
  divides each moment by its own root, so a last-bit difference in a
  near-zero gradient entry moves that parameter by up to ~lr; over 20
  steps at lr 1e-2 that shows in the grad norm at ~1e-3 (observed 7e-4)
  and in the loss at ~1e-5.
- schedule and single optimizer updates: 1e-6 relative (f32 on both
  sides; the schedule is f64 here and f32 in optax, whose warmup
  ``(0 - peak) * frac + peak`` is also allowed 1e-7 of the peak).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec, make_mesh
from ray_tpu.parallel import mesh as jmesh

from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh


def _cfgs(**kw):
    args = dict(dtype="float32")
    args.update(kw)
    return jllama.tiny(**args), tllama.tiny(**args)


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _batch(seed, b=2, s=64, vocab=512, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if mask:
        batch["mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    return batch


LOSS_CASES = [
    ("plain", dict(), False),
    ("mask", dict(), True),
    ("ce_chunk", dict(ce_chunk=16), True),
    ("ce_chunk_whole_seq", dict(ce_chunk=64), False),
    ("no_remat", dict(remat=False), True),
    ("remat_none", dict(remat_policy="none"), False),
]


@pytest.mark.parametrize("name,kw,mask", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_loss_and_grads_match_jax(name, kw, mask):
    jcfg, tcfg = _cfgs(**kw)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(sum(map(ord, name)), mask=mask)
    want_loss, want_grads = jax.value_and_grad(jllama.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    model = bridge.params_from_numpy(_tree_np(params), tcfg, "cpu",
                                     trainable=True)
    loss = tllama.loss_fn(model, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    flat_w, tree_w = jax.tree.flatten(_tree_np(want_grads))
    flat_g, tree_g = jax.tree.flatten(bridge.grads_to_numpy(model))
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, atol=2e-5 * np.abs(w).max(),
                                   rtol=0)


def test_remat_recomputes_attention_forward(monkeypatch):
    """Full remat runs each layer's forward again in the backward: the
    attention forward runs 2 * n_layers times per step, none without
    remat; the backward once per layer either way."""
    from ray_tpu_torch.ops import attention as TA
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = TA.flash_attention_fwd, TA.flash_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += k.get("with_lse", False)
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(TA, "flash_attention_fwd", count_fwd)
    monkeypatch.setattr(TA, "flash_attention_bwd", count_bwd)
    for remat, fwd_calls in ((True, 4), (False, 2)):
        _, tcfg = _cfgs(remat=remat)
        model = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                   "cpu", trainable=True)
        calls.update(fwd=0, bwd=0)
        tllama.loss_fn(model, {k: torch.from_numpy(v) for k, v in
                               _batch(0, s=16).items()}).backward()
        assert calls == {"fwd": fwd_calls, "bwd": 2}, (remat, calls)


def test_train_trajectory_matches_jax_make_train_step():
    """20 steps of the JAX make_train_step on a one-device mesh against
    the port's, from the same parameters (bridged), on the same batches,
    with default_optimizer(1e-2, warmup 3, total 20) on both sides."""
    jcfg, tcfg = _cfgs()
    mesh = make_mesh(MeshSpec(data=1, fsdp=1, tensor=1, context=1),
                     devices=jax.devices()[:1])
    kw = dict(learning_rate=1e-2, warmup_steps=3, total_steps=20)
    j_init, j_step = jmesh.make_train_step(
        jcfg, mesh, optimizer=jmesh.default_optimizer(**kw))
    j_state = j_init(jax.random.PRNGKey(0))
    t_init, t_step = tmesh.make_train_step(
        tcfg, device="cpu", optimizer=tmesh.default_optimizer(**kw))
    t_state = t_init(params=bridge.params_from_numpy(
        _tree_np(j_state.params), tcfg, "cpu", trainable=True))
    batches = [_batch(i % 2) for i in range(20)]
    j_hist, t_hist = [], []
    for batch in batches:
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        j_hist.append((float(jm["loss"]), float(jm["grad_norm"])))
        t_hist.append((tm["loss"].item(), tm["grad_norm"].item()))
    assert t_state.step == 20 and tm["step"] == 20
    j_hist, t_hist = np.array(j_hist), np.array(t_hist)
    np.testing.assert_allclose(t_hist[:, 0], j_hist[:, 0], rtol=1e-4)
    np.testing.assert_allclose(t_hist[:, 1], j_hist[:, 1], rtol=5e-3)
    assert t_hist[-1, 0] < t_hist[0, 0] - 0.5     # it learns the batches


@pytest.mark.parametrize("warmup,total", [(3, 20), (0, 10), (5, 5),
                                          (100, 10_000)])
def test_schedule_matches_optax(warmup, total):
    opt = tmesh.default_optimizer(learning_rate=3e-4, warmup_steps=warmup,
                                  total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup, max(total, warmup + 1))
    counts = list(range(0, max(total, warmup + 1) + 5)) + [10 * total]
    for c in counts:
        # optax computes (0 - peak) * frac + peak in f32: its error is
        # f32 rounding relative to the peak, not to the value
        np.testing.assert_allclose(opt.schedule(c), float(sched(c)),
                                   rtol=1e-6, atol=1e-7 * 3e-4)
    if warmup:
        assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["below_clip", "clipped"])
def test_optimizer_updates_match_optax(grad_scale):
    """Three updates of random f32 parameters with random gradients,
    global norm below and above the clip, against optax's chain."""
    rng = np.random.default_rng(int(grad_scale * 100))
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[grad_scale * rng.normal(size=s).astype(np.float32)
              for s in shapes] for _ in range(3)]
    kw = dict(learning_rate=0.1, warmup_steps=1, total_steps=4,
              weight_decay=0.1, grad_clip=1.0)
    jopt = jmesh.default_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    opt = tmesh.default_optimizer(**kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(x.copy()) for x in g]
        norm = tmesh.global_norm(tg)
        np.testing.assert_allclose(norm.item(),
                                   float(optax.global_norm(g)), rtol=1e-6)
        opt.update(tstate, tp, tg, norm)
    assert tstate.count == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_moments_keep_the_parameter_dtype():
    """optax's mu_dtype=None: bf16 parameters keep bf16 moments."""
    p = [torch.zeros(4, dtype=torch.bfloat16), torch.zeros(2)]
    state = tmesh.default_optimizer().init(p)
    assert [m.dtype for m in state.mu] == [torch.bfloat16, torch.float32]
    assert [m.dtype for m in state.nu] == [torch.bfloat16, torch.float32]


def test_eval_step_and_flops_match_jax():
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    batch = _batch(4, mask=True)
    want = jmesh.make_eval_step(jcfg, make_mesh(
        MeshSpec(data=1, fsdp=1, tensor=1, context=1),
        devices=jax.devices()[:1]))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = bridge.params_from_numpy(_tree_np(params), tcfg, "cpu")
    got = tmesh.make_eval_step(tcfg)(model, batch)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for name in ("tiny", "llama3_8b", "llama2_7b"):
        j, t = getattr(jllama, name)(), getattr(tllama, name)()
        assert t.flops_per_token(4096) == j.flops_per_token(4096)


def test_trainable_models_and_rejected_options():
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    model = tllama.init_params(g, tcfg, "cpu", trainable=True)
    assert model.training and all(p.requires_grad
                                  for p in model.parameters())
    frozen = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                                "cpu")
    assert not frozen.training
    assert torch.equal(frozen.lm_head.weight, model.lm_head.weight)
    tree = bridge.params_to_numpy(model)
    again = bridge.params_from_numpy(tree, tcfg, "cpu", trainable=True)
    assert all(p.requires_grad for p in again.parameters())
    batch = {k: torch.from_numpy(v) for k, v in _batch(0, s=60).items()}
    for policy in ("dots", "attn"):     # ported: they train
        cfg = tllama.tiny(dtype="float32", remat_policy=policy)
        assert torch.isfinite(tllama.loss_fn(model, batch, cfg))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.loss_fn(model, batch, tllama.tiny(dtype="float32",
                                                 remat_policy="most"))
    with pytest.raises(ValueError, match="must divide seq len 60"):
        tllama.loss_fn(model, batch, tllama.tiny(dtype="float32",
                                                 ce_chunk=16))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmesh.make_train_step(tcfg, mesh=object())
    init_fn, _ = tmesh.make_train_step(tcfg, device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        init_fn(params=frozen)
