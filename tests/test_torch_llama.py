"""The port's Llama decoder and weight bridge against the JAX package.

The JAX package's own seeded weights cross through the bridge; the
forward runs at tiny widths in f32 on both sides. f32 tolerance 1e-5
relative to the logits' scale: XLA-CPU and torch-CPU reduce matmuls in
different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama

from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tllama


def _cfgs(dtype="float32", **kw):
    args = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, ffn_dim=128, dtype=dtype,
                attn_impl="reference")
    args.update(kw)
    return jllama.tiny(**args), tllama.tiny(**args)


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bitwise(dtype):
    jcfg, tcfg = _cfgs(dtype)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    model = bridge.params_from_numpy(_tree_np(params), tcfg, "cpu")
    assert model.dtype == getattr(torch, dtype)
    back = bridge.params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(_tree_np(params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_bridge_transposes_linears_only():
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    model = bridge.params_from_numpy(_tree_np(params), tcfg, "cpu")
    wq = np.asarray(params["layers"]["wq"][1])
    assert np.array_equal(model.layers[1].wq.weight.numpy(), wq.T)
    assert np.array_equal(model.embed.weight.numpy(),
                          np.asarray(params["embed"]))


@pytest.mark.parametrize("seq", [1, 17, 64])
def test_forward_logits_match_jax(seq):
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    model = bridge.params_from_numpy(_tree_np(params), tcfg, "cpu")
    tokens = np.random.default_rng(seq).integers(
        0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    want = np.asarray(jllama.forward(params, jnp.asarray(tokens), jcfg))
    got = tllama.forward(model, torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-5)


def test_forward_bf16_close_to_jax():
    """bf16 weights and activations: both sides round every matmul and
    norm output to bf16 (2^-8 relative), at different points; through
    two layers the logits stay within 5% of their scale."""
    jcfg, tcfg = _cfgs("bfloat16")
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    model = bridge.params_from_numpy(_tree_np(params), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (1, 24)).astype(np.int32)
    want = np.asarray(jllama.forward(params, jnp.asarray(tokens), jcfg))
    got = tllama.forward(model, torch.from_numpy(tokens)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-2 * scale


def test_init_params_shapes_and_scale():
    """Every tensor has the JAX tree's shape once bridged, norms are one
    and weights are normal * fan_in^-0.5."""
    jcfg, tcfg = _cfgs(n_layers=3)
    g = torch.Generator().manual_seed(0)
    model = tllama.init_params(g, tcfg, "cpu")
    ref = jax.eval_shape(lambda: jllama.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    tree = bridge.params_to_numpy(model)
    shapes = jax.tree.map(lambda x: tuple(x.shape), tree)
    want = jax.tree.map(lambda x: tuple(x.shape), ref)
    assert shapes == want
    assert sum(p.numel() for p in model.parameters()) == \
        tcfg.num_params()
    assert np.all(tree["final_norm"] == 1.0)
    assert np.all(tree["layers"]["attn_norm"] == 1.0)
    for name, fan_in in (("wq", tcfg.dim), ("w_down", tcfg.ffn_dim),
                         ("wo", tcfg.n_heads * tcfg.head_dim)):
        std = tree["layers"][name].std() * fan_in ** 0.5
        assert abs(std - 1.0) < 0.05, (name, std)
    assert not any(p.requires_grad for p in model.parameters())
    # same generator seed, same weights
    again = tllama.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert torch.equal(again.lm_head.weight, model.lm_head.weight)


def test_presets_match_jax_field_for_field():
    for name in ("llama2_7b", "llama2_13b", "llama3_8b", "tiny"):
        j = getattr(jllama, name)()
        t = getattr(tllama, name)()
        assert [(f, getattr(j, f)) for f in j.__dataclass_fields__] == \
            [(f, getattr(t, f)) for f in t.__dataclass_fields__], name
        assert t.head_dim == j.head_dim
        assert t.num_params() == j.num_params()
