"""The port's goodput ledger (ray_tpu_torch/util/goodput.py) and its
peak table held to the JAX package's own tests.

``tests/test_zz_goodput.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename), with
``util/state.py``'s goodput view and the ``scripts.py`` CLI. Nothing is
left out. Each test starts on an empty event buffer (``_fresh_events``):
the buffer is process-global, and an earlier file in the same test
worker can leave rank-1 goodput step events there, which
``test_step_events_and_state_anatomy_rows`` would average with its own.
Beside them: the ledger's peak on a card (``_peak`` reads the CUDA
device's name; no card, no MFU gauge), and the device monitor's builds
booked as the compile category.
"""

import sys

import pytest

from _torch_ported import adopt, ported

from ray_tpu_torch.util import accelerators, devmon, events, goodput

adopt(ported("test_zz_goodput"), globals())


@pytest.fixture(autouse=True)
def _fresh_events():
    events.clear()
    yield
    events.clear()


def test_peak_from_the_cuda_device_name(monkeypatch):
    """``_peak`` resolves the H100's 989 TF/s from
    ``torch.cuda.get_device_name``, and nothing without a card."""
    import torch
    assert accelerators.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    goodput.set_model_flops(989e12 * 0.25)
    goodput.record_step(1, 1.0, rank=7, compute=1.0)
    assert goodput.goodput_metrics()["mfu"]._values[(("rank", "7"),)] == \
        pytest.approx(0.25)
    goodput.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert goodput._peak() is None


def test_peak_probe_imports_no_torch(monkeypatch):
    """A process that never imported torch (a runtime worker before its
    task) resolves no peak and is not made to import torch."""
    monkeypatch.delitem(sys.modules, "torch")
    assert goodput._peak() is None
    assert "torch" not in sys.modules


def test_kernel_builds_book_compile_time(monkeypatch):
    """A real build recorded by the device monitor is booked as compile
    seconds (here outside a step window: verbatim on the counter); a
    library found on disk books nothing."""
    monkeypatch.setattr(devmon, "_ENABLED", True)
    goodput.set_rank(5)
    seconds = goodput.goodput_metrics()["seconds"]._values
    key = (("category", "compile"), ("rank", "5"))
    before = seconds.get(key, 0.0)
    devmon.record_compile("flash_attention_fwd.cu", 0.25)
    devmon.record_compile("flash_attention_fwd.cu", 0.5, cache_hit=True)
    assert seconds[key] - before == pytest.approx(0.25)
