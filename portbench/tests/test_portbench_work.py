"""The frozen work arithmetic reproduces the kernel table's bounds and
the configs' FLOPs per token."""

import json

import pytest

from portbench.bench import model as bm
from portbench.tests._tiny import ROOT
from portbench.work import attention as wa
from portbench.work import flops as wf

SHAPE = dict(b=1, s=4096, h=32, kvh=8, d=128, itemsize=2)


def spec(name):
    return bm.spec_from_config(json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text()))


@pytest.mark.parametrize("work,ms", [("flash_fwd", 0.1390),
                                     ("flash_bwd_dkv", 0.2780),
                                     ("flash_bwd_dq", 0.2085)])
def test_training_kernel_bounds(work, ms):
    # PERF.md's kernel table: b 1, s 4096, 32/8 heads, d 128, causal
    assert round(wa.bound_s(wa.WORK[work](**SHAPE)) * 1e3, 4) == ms


def test_decode_kernel_bound():
    # 8 slots, 3044 live tokens in all, 8 kv heads, groups of 4, bf16
    lengths = [380] * 7 + [3044 - 7 * 380]
    w = wa.paged_decode(lengths, kvh=8, g=4, d=128, pool_itemsize=2,
                        q_itemsize=2)
    assert round(wa.bound_s(w) * 1e3, 4) == 0.0038


def test_pairs_match_the_sum():
    for sq, sk in ((5, 5), (3, 7), (1, 4)):
        assert wa._pairs(sq, sk, True) == sum(
            min(sk, i + sk - sq + 1) for i in range(sq))


def test_flops_per_token():
    m = spec("mistral-7b-v0.3")
    assert abs(wf.train_flops_per_token(m, 4096) - 49.12e9) < 0.01e9
    moe = spec("mixtral-8x7b-v0.1")
    # 4 layers: attention 41.9M + router and 2 experts' 352.3M each, head
    per_layer = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 4096 * 8 \
        + 3 * 2 * 4096 * 14336
    want = 6 * (4 * per_layer + 4096 * 32000) + 12 * 4 * 4096 * 4096
    assert wf.train_flops_per_token(moe, 4096) == want


def test_request_flops_counts_every_fed_token():
    m = spec("mistral-7b-v0.3")
    got = wf.request_flops(m, 3, 2)
    want = sum(wf.forward_flops(m, c) for c in (1, 2, 3, 4))
    assert got == pytest.approx(want)
