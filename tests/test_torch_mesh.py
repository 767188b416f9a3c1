"""The port's mesh (ray_tpu_torch/parallel/mesh.py ``MeshSpec``,
``make_mesh``, ``DeviceMesh``; models/llama.py ``param_shardings``,
``shard_params_for_training``) against the JAX package's.

``MeshSpec.resolve`` is held to the JAX one over a table of specs, the
errors included (the same messages); ``make_mesh`` to the JAX mesh's axis
names, sizes and device order over the 8 virtual CPU devices (the port's
mesh over eight CPU stand-ins); each block of the port's layout to the
shard shape JAX's ``NamedSharding`` gives the same weight on ``mesh8``,
transposed into the (out, in) layout; the collectives to numpy, exactly
(sums of small integers)."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import DeviceMesh, MeshSpec, make_mesh

SPECS = [
    dict(),
    dict(data=1, fsdp=2, tensor=2, context=2),
    dict(data=2, fsdp=2, tensor=2, context=1),
    dict(data=2, fsdp=-1, tensor=1, context=1),
    dict(data=-1, fsdp=1, tensor=4, context=1),
    dict(data=1, fsdp=1, tensor=2, context=-1),
    dict(data=1, fsdp=8, tensor=1, context=1),
    dict(data=-1, fsdp=-1),                      # two unknowns
    dict(data=3, fsdp=-1),                       # 8 % 3
    dict(data=2, fsdp=2, tensor=1, context=1),   # 4 != 8
    dict(data=1, fsdp=1, tensor=1, context=1, expert=-1),
]


@pytest.mark.parametrize("kw", SPECS, ids=[str(k) for k in SPECS])
@pytest.mark.parametrize("n", [8, 4, 1])
def test_resolve_matches_jax(kw, n):
    def run(spec):
        try:
            return ("ok", spec.resolve(n))
        except ValueError as e:
            return ("error", str(e))
    assert run(MeshSpec(**kw)) == run(JMeshSpec(**kw))


@pytest.mark.parametrize("kw", SPECS[:7], ids=[str(k) for k in SPECS[:7]])
def test_make_mesh_matches_jax(kw):
    jmesh = jmake_mesh(JMeshSpec(**kw))
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = make_mesh(MeshSpec(**kw), devices=devs)
    assert isinstance(mesh, DeviceMesh)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    # shard j sits at the same place of the grid as JAX's device j
    want = [d.id for d in jmesh.devices.flat]
    assert [int(str(d).split(":")[1]) for d in mesh.devices] == want
    for j in range(mesh.size):
        assert mesh.index(mesh.coords(j)) == j


def test_expert_axis_and_no_card(monkeypatch):
    mesh = make_mesh(MeshSpec(fsdp=1, expert=2), devices=("cpu",) * 2)
    assert mesh.shape["expert"] == 2 and mesh.groups("expert") == [[0, 1]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(MeshSpec())
    mesh = make_mesh(MeshSpec(fsdp=1), devices=("cpu",))
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1, "context": 1,
                          "expert": 1}


@pytest.mark.parametrize("kw", [dict(data=1, fsdp=2, tensor=2, context=2),
                                dict(data=2, fsdp=2, tensor=2, context=1),
                                dict(data=1, fsdp=4, tensor=2, context=1)],
                         ids=["mesh8", "dp2", "fsdp4"])
def test_param_shardings_blocks_match_jax(kw):
    """Every block of ``shard_params_for_training`` has the shape of the
    JAX shard of the same weight (per layer, transposed) and holds that
    shard's values."""
    cfg = dict(dtype="float32")
    jcfg, tcfg = jllama.tiny(**cfg), tllama.tiny(**cfg)
    jmesh = jmake_mesh(JMeshSpec(**kw))
    mesh = make_mesh(MeshSpec(**kw), devices=("cpu",) * 8)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    specs = jllama.param_shardings(jcfg)
    from ray_tpu_torch import bridge
    model = bridge.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), tcfg,
        "cpu")
    sm = tllama.shard_params_for_training(model, mesh)
    assert tllama.param_shardings(tcfg)["layers"].keys() == \
        specs["layers"].keys()
    blocks = dict(zip([n for n, _ in sm.named_parameters()],
                      sm.parameters()))
    full = dict(model.named_parameters())
    for (pname, p), (name, idx) in zip(sm.named_parameters(), sm.layout()):
        leaf = name.split(".")
        if leaf[0] == "layers":
            jspec, jshape = specs["layers"][leaf[2]], \
                jparams["layers"][leaf[2]].shape
        else:
            jspec, jshape = specs[leaf[0]], jparams[leaf[0]].shape
        shard = NamedSharding(jmesh, jspec).shard_shape(jshape)
        if leaf[0] == "layers":
            shard = shard[1:]                     # the stacked layer axis
        if p.ndim == 2 and leaf[-1] != "weight" or leaf[0] == "embed":
            want = tuple(shard)
        else:
            want = tuple(shard)[::-1]              # (in, out) -> (out, in)
        assert tuple(p.shape) == want, (pname, p.shape, want)
        assert torch.equal(p.detach(), full[name][idx])
        assert p.requires_grad and p.is_leaf
    assert len(blocks) == len(list(sm.parameters()))


def _parts(mesh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-9, 9, (2, 4)).astype(np.float32))
            for _ in range(mesh.size)]


def test_collectives_match_numpy():
    mesh = make_mesh(MeshSpec(data=2, fsdp=1, tensor=2, context=2),
                     devices=("cpu",) * 8)
    parts = _parts(mesh, 0)
    grid = np.stack([p.numpy() for p in parts]).reshape(2, 1, 2, 2, 1, 2, 4)
    ax = mesh.axis_names.index("tensor")
    red = mesh.all_reduce(parts, "tensor")
    gat = mesh.all_gather(parts, "tensor", 1)
    sca = mesh.reduce_scatter(parts, "tensor", 1)
    rot = mesh.ring_shift(parts, "context")
    for j in range(mesh.size):
        at = tuple(mesh.coords(j).values())
        other = list(at)
        np.testing.assert_array_equal(red[j].numpy(),
                                      grid.sum(axis=ax)[at[:ax] + at[ax + 1:]])
        blocks = []
        for t in range(2):
            other[ax] = t
            blocks.append(grid[tuple(other)])
        np.testing.assert_array_equal(gat[j].numpy(),
                                      np.concatenate(blocks, 1))
        np.testing.assert_array_equal(
            sca[j].numpy(), np.split(sum(blocks), 2, 1)[at[ax]])
        c = mesh.axis_names.index("context")
        src = list(at)
        src[c] = (at[c] - 1) % 2
        np.testing.assert_array_equal(rot[j].numpy(), grid[tuple(src)])
    with pytest.raises(ValueError, match="parts for a mesh"):
        mesh.all_reduce(parts[:3], "tensor")


def test_collectives_are_differentiable_and_keep_shard_order():
    """The backward of a gather is the slice of the gradient, of a sum
    the gradient itself, of the ring shift the reverse shift."""
    mesh = make_mesh(MeshSpec(fsdp=1, tensor=2, context=2),
                     devices=("cpu",) * 4)
    parts = [p.requires_grad_(True) for p in _parts(mesh, 1)]
    weights = _parts(mesh, 2)
    outs = (mesh.all_gather(parts, "tensor", 0)
            + mesh.all_reduce(parts, "context")
            + mesh.ring_shift(parts, "context"))
    sum((o * w.repeat(o.shape[0] // 2, 1)).sum()
        for o, w in zip(outs, weights * 3)).backward()
    for j, p in enumerate(parts):
        co = mesh.coords(j)
        g_gather = sum(weights[i].repeat(2, 1)[co["tensor"] * 2:][:2]
                       for i in mesh.groups("tensor")[
                           [j in g for g in mesh.groups("tensor")].index(
                               True)])
        group = next(g for g in mesh.groups("context") if j in g)
        g_sum = sum(weights[i] for i in group)
        g_rot = weights[group[(group.index(j) + 1) % 2]]
        np.testing.assert_array_equal(p.grad.numpy(),
                                      (g_gather + g_sum + g_rot).numpy())


def test_shard_batch_blocks_and_sharing():
    mesh = make_mesh(MeshSpec(data=2, fsdp=2, tensor=2, context=1),
                     devices=("cpu",) * 8)
    toks = np.arange(8 * 6).reshape(8, 6)
    parts = tllama.shard_batch({"tokens": toks, "mask": None}, mesh)
    assert set(parts) == {"tokens"}
    for j, p in enumerate(parts["tokens"]):
        co = mesh.coords(j)
        r = co["data"] * 2 + co["fsdp"]
        np.testing.assert_array_equal(p.numpy(), toks[2 * r:2 * r + 2])
    # the two tensor shards of a block on one device share the tensor
    t0 = mesh.index(dict(data=1, fsdp=0, tensor=0))
    t1 = mesh.index(dict(data=1, fsdp=0, tensor=1))
    assert parts["tokens"][t0] is parts["tokens"][t1]
    with pytest.raises(ValueError, match="data x fsdp size 4"):
        tllama.shard_batch({"tokens": toks[:6]}, mesh)
    cp = make_mesh(MeshSpec(fsdp=1, context=4), devices=("cpu",) * 4)
    with pytest.raises(ValueError, match="context size 4"):
        tllama.shard_batch({"tokens": toks}, cp)


def test_shard_params_checks_divisibility():
    cfg = tllama.tiny(dtype="float32", n_kv_heads=1)
    model = tllama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = make_mesh(MeshSpec(fsdp=1, tensor=2), devices=("cpu",) * 2)
    with pytest.raises(ValueError, match="n_kv_heads=1 not divisible"):
        tllama.shard_params_for_training(model, mesh)
    with pytest.raises(TypeError, match="shard_params_for_training"):
        tllama.loss_fn(model, {"tokens": torch.zeros(2, 8, dtype=torch.long),
                               "targets": torch.zeros(2, 8,
                                                      dtype=torch.long)},
                       cfg, mesh)
