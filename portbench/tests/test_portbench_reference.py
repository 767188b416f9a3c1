"""The plain reference against the port's CPU path on a tiny config, and
its independence from the program."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from portbench.bench import model as bm
from portbench.reference import model as ref
from portbench.reference.control import CONTROL
from portbench.tests._tiny import ROOT, TINY_CONFIG


def tiny(name):
    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg.update(TINY_CONFIG)
    return bm.spec_from_config(cfg)


CONFIGS = ["mistral-7b-v0.3", "mixtral-8x7b-v0.1"]


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_the_port(name):
    m = tiny(name)
    pcfg = bm.port_config(m, {"remat_policy": "full"})
    W = bm.draw(m, 5, torch.device("cpu"))
    net = bm.build_program_model(m, pcfg, {k: v.clone() for k, v in W.items()},
                                 trainable=True)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, m.vocab_size, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss = bm.family_module(m).loss_fn(net, batch, pcfg)
    loss.backward()
    want, grads, sq = ref.loss_and_grads(W, batch["tokens"], batch["targets"], m)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    for pname, p in net.named_parameters():
        kind, layer = bm.leaf_of(pname)
        got = grads[kind] if layer is None else grads[kind][layer]
        scale = p.grad.norm() + 1e-12
        assert float((got - p.grad).norm() / scale) < 1e-4, pname
        assert sq[(kind, layer)] == pytest.approx(float(p.grad.norm()) ** 2,
                                                  rel=1e-4)


def test_logits_match_the_port():
    m = tiny("mistral-7b-v0.3")
    pcfg = bm.port_config(m, {})
    W = bm.draw(m, 6, torch.device("cpu"))
    net = bm.build_program_model(m, pcfg, W, trainable=False)
    toks = torch.randint(0, m.vocab_size, (40,),
                         generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = bm.family_module(m).forward(net, toks[None])[0]
    rows = torch.arange(10, 40)
    got = ref.logits_at(W, toks, rows, m)
    assert torch.allclose(got, want[rows].float(), atol=1e-4, rtol=1e-4)


def test_control_is_lower_precision():
    m = tiny("mistral-7b-v0.3")
    W = bm.draw(m, 6, torch.device("cpu"))
    toks = torch.randint(0, m.vocab_size, (40,),
                         generator=torch.Generator().manual_seed(4))
    rows = torch.arange(40)
    a = ref.logits_at(W, toks, rows, m)
    b = ref.logits_at(W, toks, rows, m, CONTROL)
    gap = float((a - b).abs().max())
    assert 1e-3 < gap < 1.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted((ROOT / "portbench/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("ray_tpu_torch", "ray_tpu", "jax", "jaxlib")
        if top == "portbench":
            assert mod.startswith("portbench.reference"), mod


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference.train, "
            "portbench.reference.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ray_tpu_torch', 'ray_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
