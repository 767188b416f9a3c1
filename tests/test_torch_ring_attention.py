"""The port's ring attention (ray_tpu_torch/ops/ring_attention.py) against
the JAX package's ``ring_attention`` under ``shard_map`` on a 4-device
context mesh, as ``tests/test_ops_attention.py`` runs it.

The same q, k, v (numpy, from a seed) go to both; the port's sequence
blocks are the JAX shards' (``make_mesh`` over four CPU stand-ins for the
virtual devices). Tolerances are the JAX tests': outputs 2e-5 absolute
and relative (f32, the same online-softmax merges in another summation
order), gradients of ``sum(out ** 2)`` 5e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.ops import shard_map
from ray_tpu.ops.ring_attention import ring_attention as jax_ring

from ray_tpu_torch.ops import ring_attention as RA
from ray_tpu_torch.ops.flash_attention import mha_reference
from ray_tpu_torch.parallel import MeshSpec, make_mesh

N = 4


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


def _jax_ring(causal):
    mesh = Mesh(np.asarray(jax.devices()[:N]).reshape(N), ("context",))
    spec = P(None, "context", None, None)
    return shard_map(
        lambda q, k, v: jax_ring(q, k, v, axis_name="context",
                                 causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)


def _port_ring(q, k, v, causal, mesh=None):
    mesh = mesh or make_mesh(MeshSpec(fsdp=1, context=N),
                             devices=("cpu",) * N)
    parts = [list(torch.from_numpy(x).chunk(N, dim=1)) if isinstance(
        x, np.ndarray) else list(x.chunk(N, dim=1)) for x in (q, k, v)]
    return torch.cat(RA.ring_attention(*parts, mesh, "context",
                                       causal=causal), dim=1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [2, 1], ids=["mha", "gqa"])
def test_ring_attention_matches_jax(causal, kvh):
    q, k, v = _qkv(3, b=2, s=128, h=2, kvh=kvh, d=32)
    want = jax.jit(_jax_ring(causal))(q, k, v)
    got = _port_ring(q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    # and against the plain attention over the whole sequence
    ref = mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_grad_matches_jax(causal):
    q, k, v = _qkv(4, b=1, s=64, h=2, kvh=2, d=16)
    f = _jax_ring(causal)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) ** 2),
                            argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (_port_ring(*ts, causal) ** 2).sum().backward()
    for w, t in zip(want, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=5e-4, rtol=5e-4)


def test_causal_ring_skips_future_chunks_and_checkpoints_steps(monkeypatch):
    """Causal: position i computes the i + 1 chunks at or before it, so
    n (n + 1) / 2 steps in all (non-causal: n * n); with grad each step
    runs under its own checkpoint and runs again in the backward."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 32, 2, 2, 8))
    calls = []
    step = RA._step
    monkeypatch.setattr(RA, "_step",
                        lambda *a: calls.append(a[-4:-2]) or step(*a))
    for causal, n_steps in ((True, N * (N + 1) // 2), (False, N * N)):
        calls.clear()
        with torch.no_grad():
            _port_ring(q, k, v, causal)
        assert len(calls) == n_steps
        if causal:
            assert all(k_off <= q_off for q_off, k_off in calls)
    calls.clear()
    qg = q.clone().requires_grad_(True)
    (_port_ring(qg, k, v, True) ** 2).sum().backward()
    assert len(calls) == 2 * N * (N + 1) // 2


def test_ring_runs_per_context_group_of_a_larger_mesh():
    """On a (tensor 2, context 2) mesh each tensor shard's context group
    runs its own ring over its own heads."""
    mesh = make_mesh(MeshSpec(fsdp=1, tensor=2, context=2),
                     devices=("cpu",) * 4)
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 2, 64, 4, 2, 16))
    parts = []
    for x in (q, k, v):
        heads = x.chunk(2, dim=2)
        parts.append([heads[mesh.coords(j)["tensor"]].chunk(2, dim=1)[
            mesh.coords(j)["context"]] for j in range(mesh.size)])
    out = RA.ring_attention(*parts, mesh)
    want = mha_reference(q, k, v, causal=True)
    for j, o in enumerate(out):
        co = mesh.coords(j)
        np.testing.assert_allclose(
            o.numpy(), want.chunk(2, dim=2)[co["tensor"]].chunk(2, dim=1)[
                co["context"]].numpy(), atol=2e-5, rtol=2e-5)
