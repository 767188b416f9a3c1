"""The port's remat policies (ray_tpu_torch/models/llama.py ``_remat``)
against the JAX package's (``ray_tpu/models/llama.py:262-280``), and
``mha_reference(segment_ids=)`` against the reference.

Tiny f32 configs on the CPU; the JAX package's seeded weights cross
through the bridge and numpy batches feed both sides. Tolerances, as in
tests/test_torch_train.py: the loss 1e-6 relative, each gradient leaf
2e-5 of its largest entry (f32 matmuls summed in other orders). Between
the port's own policies the gradients are bitwise equal: a recompute
runs the same ops on the same values, and a saved output is the value
the recompute would have produced.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.ops import attention as _jax_attention_pkg  # noqa: F401

JA = sys.modules["ray_tpu.ops.attention"]

from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.ops import flash_attention as TF

POLICIES = ("full", "attn", "dots", "none")
N_LAYERS = 3


def _cfgs(policy):
    kw = dict(dtype="float32", n_layers=N_LAYERS, remat_policy=policy)
    return jllama.tiny(**kw), tllama.tiny(**kw)


def _batch(seed, b=2, s=48, vocab=512):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _port_grads(params_np, tcfg, batch):
    model = bridge.params_from_numpy(params_np, tcfg, "cpu", trainable=True)
    loss = tllama.loss_fn(model, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    return loss.item(), bridge.grads_to_numpy(model)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_grads_match_jax(policy):
    jcfg, tcfg = _cfgs(policy)
    params = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    batch = _batch(7)
    want_loss, want_grads = jax.value_and_grad(jllama.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads = _port_grads(_tree_np(params), tcfg, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    flat_w, tree_w = jax.tree.flatten(_tree_np(want_grads))
    flat_g, tree_g = jax.tree.flatten(grads)
    assert tree_w == tree_g
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, atol=2e-5 * np.abs(w).max(),
                                   rtol=0)


def test_policies_agree_bitwise():
    params = _tree_np(jllama.init_params(jax.random.PRNGKey(6),
                                         _cfgs("full")[0]))
    batch = _batch(8)
    runs = {p: _port_grads(params, _cfgs(p)[1], batch) for p in POLICIES}
    loss0, grads0 = runs["full"]
    for policy, (loss, grads) in runs.items():
        assert loss == loss0, policy
        for a, b in zip(jax.tree.leaves(grads0), jax.tree.leaves(grads)):
            np.testing.assert_array_equal(a, b, err_msg=policy)


@pytest.mark.parametrize("policy,fwd", [("full", 2 * N_LAYERS),
                                        ("attn", N_LAYERS),
                                        ("dots", N_LAYERS),
                                        ("none", N_LAYERS)])
def test_attention_calls_per_step(policy, fwd):
    """The attention forward runs in the op's body 2L times a step under
    "full" (the recompute runs it again) and L times under the others
    ("attn" and "dots" hand the saved (o, lse) to the recompute); the
    backward runs L times under every policy. A train step counts both."""
    from ray_tpu_torch.parallel import mesh as tmesh
    _, tcfg = _cfgs(policy)
    init_fn, step_fn = tmesh.make_train_step(tcfg, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    TA.flash_fwd_lse.calls = TA._Flash.bwd_calls = 0
    state, m = step_fn(state, _batch(1, s=16))
    assert torch.isfinite(m["loss"])
    assert (TA.flash_fwd_lse.calls, TA._Flash.bwd_calls) == (fwd, N_LAYERS)


def _recording(saved_by, monkeypatch):
    """Swap the SAC context factory the model uses for one that records
    every op the policy saves (outside the recompute)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def factory(ops):
        def policy(ctx, op, *args, **kwargs):
            if op in ops:
                if not ctx.is_recompute:
                    saved_by.append(op)
                return CheckpointPolicy.MUST_SAVE
            return CheckpointPolicy.PREFER_RECOMPUTE
        return create_selective_checkpoint_contexts(policy)
    monkeypatch.setattr(tllama, "create_selective_checkpoint_contexts",
                        factory)


@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_saved_ops(policy, monkeypatch):
    """What selective checkpointing saves per layer: the attention op's
    (o, lse) under "attn"; that and the seven projections under "dots",
    each of which nn.Linear (no bias) hands the dispatcher as aten.mm.
    Nothing is saved by aten.addmm (the projections have no bias)."""
    saved = []
    _recording(saved, monkeypatch)
    _, tcfg = _cfgs(policy)
    model = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                               "cpu", trainable=True)
    tllama.loss_fn(model, {k: torch.from_numpy(v) for k, v in
                           _batch(2, s=16).items()}).backward()
    names = [str(op) for op in saved]
    per_layer = {"attn": {"ray_tpu_torch.flash_fwd_lse.default": 1},
                 "dots": {"ray_tpu_torch.flash_fwd_lse.default": 1,
                          "aten.mm.default": 7}}[policy]
    assert {n: names.count(n) for n in set(names)} == \
        {n: c * N_LAYERS for n, c in per_layer.items()}


def test_recompute_leaves_k1_counters_alone(monkeypatch):
    """Under "attn" the recompute takes the saved (o, lse): the op's body,
    and with it K1's launch counters on the card, runs once per layer,
    and _Flash's backward receives exactly the saved pair."""
    seen = []
    real = TA.flash_attention_bwd

    def spy(q, k, v, o, do, lse, **kw):
        seen.append((o.data_ptr(), lse.data_ptr()))
        return real(q, k, v, o, do, lse, **kw)
    outs = []
    real_fwd = TA.flash_attention_fwd

    def fwd(*a, **kw):
        o, lse = real_fwd(*a, **kw)
        outs.append((o.data_ptr(), lse.data_ptr()))
        return o, lse
    monkeypatch.setattr(TA, "flash_attention_bwd", spy)
    monkeypatch.setattr(TA, "flash_attention_fwd", fwd)
    _, tcfg = _cfgs("attn")
    model = tllama.init_params(torch.Generator().manual_seed(0), tcfg,
                               "cpu", trainable=True)
    tllama.loss_fn(model, {k: torch.from_numpy(v) for k, v in
                           _batch(3, s=16).items()}).backward()
    # the op's body ran once per layer; each backward read the pair that
    # body returned, handed back by the recompute
    assert len(outs) == N_LAYERS and len(seen) == N_LAYERS
    assert set(seen) == set(outs)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_segment_ids_match_jax(causal):
    rng = np.random.default_rng(11)
    b, s, h, kvh, d = 2, 24, 4, 2, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    # three packed segments per row at different cuts; row 1 starts with
    # a lone token, whose non-causal row keeps itself only
    seg = np.zeros((b, s), np.int32)
    seg[0, 9:], seg[0, 17:] = 1, 2
    seg[1, 1:], seg[1, 20:] = 1, 2
    want = np.asarray(JA.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jnp.asarray(seg)))
    got = TF.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal,
                           segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a segment sees nothing of another: moving segment 0's keys moves
    # no other segment's output
    k2 = k.copy()
    k2[0, :9] += 1.0
    moved = TF.mha_reference(torch.from_numpy(q), torch.from_numpy(k2),
                             torch.from_numpy(v), causal=causal,
                             segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(moved[0, 9:], got[0, 9:])
