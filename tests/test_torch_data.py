"""The port's datasets (ray_tpu_torch.data: plans, transforms, shuffles,
IO, iteration, splits, the actor-pool and task-pool map stages) held to
the JAX package's own tests and to its plans.

``tests/test_data.py`` runs here unedited (``_torch_ported.py``), with
``ray_tpu`` rewritten to ``ray_tpu_torch`` and one whole word renamed
from the JAX API to the port's:

    JaxTrainer -> TorchTrainer

Left out: test_iter_jax_batches (jax device arrays), written anew below
on ``iter_device_batches`` (test_iter_device_batches_gives_iter_batches_rows).
"""

import numpy as np
import pytest
import torch

from _torch_ported import adopt, ported

SKIP = {
    "test_iter_jax_batches":
        "jax arrays: test_iter_device_batches_gives_iter_batches_rows",
}

adopt(ported("test_data", rename={"JaxTrainer": "TorchTrainer"}),
      globals(), skip=SKIP)

from ray_tpu import data as jd  # noqa: E402

from ray_tpu_torch import data as td  # noqa: E402


@pytest.mark.parametrize("batch_size,drop_last,prefetch", [
    (32, True, 1), (32, False, 1), (7, False, 0), (100, True, 3)])
def test_iter_device_batches_gives_iter_batches_rows(batch_size, drop_last,
                                                     prefetch):
    """``iter_device_batches(device="cpu")`` yields the batches of
    ``iter_batches`` as CPU tensors, in order, prefetch or not; the
    JAX package's ``iter_jax_batches`` over the same plan gives the same
    values."""
    rows = [{"id": i, "x": np.arange(3, dtype=np.float32) * i,
             "t": np.full(2, i, np.int32)} for i in range(70)]
    got = list(td.from_items(rows).iter_device_batches(
        batch_size=batch_size, drop_last=drop_last, device="cpu",
        prefetch=prefetch))
    want = list(td.from_items(rows).iter_batches(batch_size=batch_size,
                                                 drop_last=drop_last))
    jax_b = list(jd.from_items(rows).iter_jax_batches(
        batch_size=batch_size, drop_last=drop_last, prefetch=prefetch))
    assert len(got) == len(want) == len(jax_b)
    for g, w, j in zip(got, want, jax_b):
        assert set(g) == set(w) == set(j)
        for k in g:
            assert isinstance(g[k], torch.Tensor)
            assert g[k].device.type == "cpu"
            assert g[k].numpy().dtype == w[k].dtype
            assert np.array_equal(g[k].numpy(), w[k])
            assert np.array_equal(g[k].numpy(), np.asarray(j[k]))


def test_iter_device_batches_defaults_to_the_card(monkeypatch):
    """``device=None`` is the CUDA device: with none it raises instead of
    yielding CPU tensors; ``sharding=`` takes a ``DeviceMesh`` only."""
    ds = td.range(8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        next(ds.iter_device_batches(batch_size=4, sharding=object()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA|no.*available"):
        next(ds.iter_device_batches(batch_size=4))
