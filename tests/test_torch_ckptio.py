"""The port's durable async checkpoint plane (ray_tpu_torch/train/ckptio,
checkpoint.py, the controller's recovery) held to the JAX package's own
tests, and a bf16 train state through it.

``tests/test_zz_ckptio.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename); its
optimizer states are optax's, which the port's checkpoint plane takes
as any numpy pytree. Left out, each for the ROADMAP.md Queue 1 item it
waits for:

- test_pipeline_stage_snapshot_restore_roundtrip,
  test_pipeline_stage_snapshot_seg_only: item 13c (pipeline stages).
"""

import os

import numpy as np
import pytest
import torch

from _torch_ported import adopt, ported

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import mesh
from ray_tpu_torch.train import ckptio

SKIP = {
    "test_pipeline_stage_snapshot_restore_roundtrip":
        "Queue 1 item 13c: pipeline stages",
    "test_pipeline_stage_snapshot_seg_only":
        "Queue 1 item 13c: pipeline stages",
}

adopt(ported("test_zz_ckptio"), globals(), skip=SKIP)


def _trained(dtype, seed, steps=2):
    cfg = llama.tiny(dtype=dtype, n_layers=2)
    init_fn, step_fn = mesh.make_train_step(
        cfg, device="cpu", optimizer=mesh.default_optimizer(
            1e-2, warmup_steps=1, total_steps=10))
    state = init_fn(torch.Generator().manual_seed(seed))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    for _ in range(steps):
        state, _ = step_fn(state, batch)
    return state, step_fn, batch


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_state_round_trips_bit_for_bit(tmp_path, dtype):
    """A trained state through state_to_numpy, an async save, restore
    into a differently seeded state and state_from_numpy: parameters
    (widened to f32 on disk), moments (bf16 as uint16 bits), the update
    count and the step come back bit for bit, and the next step of both
    is equal."""
    state, step_fn, batch = _trained(dtype, 0)
    params, opt = mesh.state_to_numpy(state)
    assert all(a.dtype == np.float32 for a in params.values())
    want_moment = np.uint16 if dtype == "bfloat16" else np.float32
    assert all(a.dtype == want_moment for a in opt["mu"].values())
    ck = ckptio.AsyncCheckpointer(str(tmp_path), rank=0, world=1)
    try:
        assert ck.save(state.step, params, opt)
        assert ck.flush(timeout_s=30)
    finally:
        ck.close()
    path = os.path.join(str(tmp_path), ckptio.ckpt_dirname(state.step))
    assert ckptio.validate_checkpoint(path, deep=True)
    other, _, _ = _trained(dtype, 1, steps=1)
    got_p, got_o, step = ckptio.restore(*mesh.numpy_template(other),
                                        checkpoint=path, rank=0, world=1)
    mesh.state_from_numpy(other, got_p, got_o)
    assert (step, other.step, other.opt_state.count) == (2, 2, 2)
    for a, b in zip(list(state.params.parameters()) + state.opt_state.mu
                    + state.opt_state.nu,
                    list(other.params.parameters()) + other.opt_state.mu
                    + other.opt_state.nu):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    _, m1 = step_fn(state, batch)
    _, m2 = step_fn(other, batch)
    assert m1["loss"].item() == m2["loss"].item()
    assert m1["grad_norm"].item() == m2["grad_norm"].item()


def test_state_from_numpy_refuses_another_model():
    state, _, _ = _trained("float32", 0, steps=0)
    params, opt = mesh.state_to_numpy(state)
    params.pop(next(iter(params)))
    with pytest.raises(ValueError, match="not the model's"):
        mesh.state_from_numpy(state, params, opt)


def test_sharded_optimizer_waits_for_item_13(tmp_path):
    """``save(opt=ShardedOptimizer)`` (raising until item 13 was ported)
    writes the ZeRO shard: a one-worker ShardedOptimizer over the port's
    ShardAdamW, its moments torch tensors, saved with ``opt=``, restores
    into a fresh ``opt.init`` template with the parameters and moments
    equal, and the next update from the restored state equals the next
    update from the live one."""
    from ray_tpu_torch.parallel import ShardAdamW
    from ray_tpu_torch.train.zero import ShardedOptimizer
    rng = np.random.default_rng(3)
    params = {"w": torch.tensor(rng.standard_normal((4, 5)),
                                dtype=torch.float32),
              "b": torch.tensor(rng.standard_normal(7),
                                dtype=torch.bfloat16)}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt = ShardedOptimizer(ShardAdamW(mesh.default_optimizer(
        1e-2, warmup_steps=1, total_steps=10), device="cpu"))
    state = opt.init(params)
    for _ in range(2):
        params, state = opt.update(grads, state, params)
    ck = ckptio.AsyncCheckpointer(str(tmp_path), rank=0, world=1)
    try:
        assert ck.save(2, params, state, opt, block=True)
    finally:
        ck.close()
    path = os.path.join(str(tmp_path), ckptio.ckpt_dirname(2))
    got_p, got_s, step = ckptio.restore(
        {k: np.zeros(tuple(v.shape), np.float32) for k, v in params.items()},
        state_template=opt.init(params), checkpoint=path, rank=0, world=1)
    assert step == 2 and int(got_s.count) == state.count == 2
    for k, v in params.items():
        assert np.array_equal(got_p[k], v.float().numpy())
    assert np.array_equal(np.asarray(got_s.mu), state.mu.numpy())
    assert np.array_equal(np.asarray(got_s.nu), state.nu.numpy())
    back = {k: torch.from_numpy(got_p[k]).to(v.dtype)
            for k, v in params.items()}
    live, _ = opt.update(grads, state, params)
    again, _ = opt.update(grads, got_s, back)
    for k in params:
        assert torch.equal(live[k], again[k])
