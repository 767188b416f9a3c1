"""A whole run, at a tiny size on the CPU, with the timed path broken
underneath: each fault the cell can have makes ``correct`` false, and the
control, the reference in float8 in the program's place, fails the
cell's limits. The sound run reads true."""

import types

import pytest
import torch

from portbench.bench import model as bm
from portbench.bench.manifest import Manifest
from portbench.bench.runner import judge
from portbench.reference.control import CONTROL
from portbench.tests import _tiny

TRAIN = ["mistral7b.train.s4096"]
SERVE = "mistral7b.serve.conv64"


@pytest.mark.parametrize("cell", TRAIN + [SERVE])
def test_a_sound_run_is_correct(cell):
    assert _tiny.run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_caught(cell, monkeypatch):
    from ray_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh.AdamW, "update", lambda self, *a, **k: None)
    line = _tiny.run(cell)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_caught(cell, monkeypatch):
    from ray_tpu_torch.models import llama, moe
    fam = moe if "mixtral" in cell else llama
    full = fam.loss_fn

    def half(model, batch, *a, **k):
        n = batch["tokens"].shape[0] // 2
        return full(model, {k2: v[:n] for k2, v in batch.items()}, *a, **k)
    monkeypatch.setattr(fam, "loss_fn", half)
    assert not _tiny.run(cell)["correct"]


def test_an_altered_token_is_caught(monkeypatch):
    from ray_tpu_torch.llm.engine import LLMEngine
    emit = LLMEngine._emit_token

    def altered(self, r, tok, slot):
        if len(r.out) == 1:     # the second token of every request
            tok = (int(tok) + 1) % self.cfg.vocab_size
        return emit(self, r, tok, slot)
    monkeypatch.setattr(LLMEngine, "_emit_token", altered)
    assert not _tiny.run(SERVE)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_control_fails_the_limits(cell):
    from portbench.generators import train_steps as ts
    man = Manifest(_tiny.ROOT)
    w = man.cell(cell)
    ov = _tiny.overrides(cell, torch_dtype="bfloat16")
    cfg = dict(man.config(w), **ov["config"])
    traffic = dict(man.traffic(w), **ov["traffic"])
    ctx = types.SimpleNamespace(spec=bm.spec_from_config(cfg),
                                traffic=traffic, seed=_tiny.SEED,
                                device=torch.device("cpu"))
    ref = ts.reference_readings(ctx)
    ctl = ts.reference_readings(ctx, CONTROL)
    numbers, _ = ts.compare(ctl, ref)
    correct, _ = judge(numbers, man.limits(w))
    assert not correct


def test_the_control_fails_the_serving_limit():
    from portbench.generators import closed_loop_engine as ce
    man = Manifest(_tiny.ROOT)
    w = man.cell(SERVE)
    ov = _tiny.overrides(SERVE, torch_dtype="bfloat16")
    cfg = dict(man.config(w), **ov["config"])
    ctx = types.SimpleNamespace(spec=bm.spec_from_config(cfg),
                                seed=_tiny.SEED, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(9)
    picked = [{"prompt": torch.randint(0, 512, (40,), generator=gen).tolist(),
               "out": torch.randint(0, 512, (24,), generator=gen).tolist()}]
    gaps = ce.token_gaps(ctx, picked, [CONTROL])
    correct, _ = judge({"token_gap": gaps[CONTROL.name]}, man.limits(w))
    assert not correct
