"""A run's last line, the checks on the card and the checkout, and the
check that no module of JAX or of the JAX package was loaded."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.bench.runner import foreign_modules
from portbench.tests import _tiny

CELLS = ["mistral7b.train.s4096", "mistral7b.serve.conv64"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_gives_a_well_formed_line(cell, trace, monkeypatch):
    if trace:
        # the CPU launches no device kernel for the readers to find (see
        # the test below): each listed metric reads 1 here
        from portbench.bench import runner
        monkeypatch.setattr(runner, "read_per_layer", lambda man, c, rctx: {
            m["name"]: {"value": 1.0, "unit": m["unit"]}
            for m in man.per_layer(c)})
    line = _tiny.run(cell, seconds=0.5, trace=trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_window_without_the_layers_kernels_fails_the_run(cell):
    """On the CPU the traced window holds no device kernel: the run fails
    naming a metric's layer instead of leaving the metric out."""
    with pytest.raises(RuntimeError, match=r"\(layer [^)]+\)"):
        _tiny.run(cell, seconds=0.5, trace=True)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=_tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(_tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_foreign_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "ray_tpu", "ray_tpu.models", "ray_tpu_torch", "ray_tpu_torch.ops",
             "jaxtyping", "numpy", "portbench.run"]
    assert foreign_modules(names) == ["flax.linen", "jax", "jax.numpy",
                                      "jaxlib.xla_client", "ray_tpu",
                                      "ray_tpu.models"]


@pytest.mark.parametrize("extra,found", [("", "[]"),
                                         ("import ray_tpu", "['ray_tpu']")])
def test_the_port_loads_no_jax(extra, found):
    code = ("import ray_tpu_torch.llm.engine, ray_tpu_torch.parallel, "
            "ray_tpu_torch.models.moe, portbench.generators.train_steps, "
            "portbench.generators.closed_loop_engine\n" + extra + "\n"
            "from portbench.bench.runner import foreign_modules\n"
            "print(sorted({m.split('.')[0] for m in foreign_modules()}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == found, out.stderr[-2000:]
