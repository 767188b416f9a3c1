"""A seeded data pipeline in both packages, executed in-process (no
runtime initialised in this module, so neither package fans out to
tasks): the port's ``ray_tpu_torch.data`` gives the JAX package's
blocks, block by block and column by column."""

import numpy as np

from ray_tpu import data as jd

from ray_tpu_torch import data as td


def _plan(data):
    rng = np.random.default_rng(5)
    n = 300
    ds = data.from_blocks([{"k": rng.integers(0, 7, n),
                            "v": rng.standard_normal(n),
                            "id": np.arange(n)}])
    return (ds.random_shuffle(seed=11)
            .map_batches(lambda b: {"k": b["k"], "v": b["v"] * 2.0,
                                    "id": b["id"]}, batch_size=64)
            .sort("id", descending=True))


def _blocks(ds):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in ds.iter_blocks()]


def test_plans_give_the_jax_package_blocks():
    """A seeded random_shuffle / map_batches / sort plan, a groupby
    aggregate and a repartition give identical blocks in both
    packages."""
    for make in (_plan,
                 lambda d: _plan(d).groupby("k").sum("v"),
                 lambda d: _plan(d).random_shuffle(seed=3).repartition(4)):
        got, want = _blocks(make(td)), _blocks(make(jd))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in g:
                assert g[k].dtype == w[k].dtype
                assert np.array_equal(g[k], w[k])
