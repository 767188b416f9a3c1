"""A cell, a traffic mix, a per-layer metric and a kernel attribution
added as new files and new entries, with no existing file edited."""

import hashlib
import json
import os
import shutil

from portbench.bench.runner import run_cell
from portbench.tests import _tiny


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and ".cache" not in p.parts
            and "__pycache__" not in p.parts}


def test_add_a_cell_a_mix_a_metric_and_a_kernel(tmp_path):
    src = _tiny.ROOT
    shutil.copytree(src / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(src / "ray_tpu_torch", tmp_path / "ray_tpu_torch")
    before = digest(tmp_path)
    bench = json.loads((src / "BENCHMARK.json").read_text())
    pkg = tmp_path / "portbench"
    mix = json.loads((pkg / "traffic" / "train.b2.s4096.json").read_text())
    mix["batch"], mix["seq"] = 1, 2048
    (pkg / "traffic" / "train.b1.s2048.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "train_steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.run['traced_steps'])\n")
    (pkg / "kernels" / "train_attention.later.json").write_text(json.dumps(
        {"set": "train_attention", "layer": "K1-K3 flash attention",
         "kernels": [{"match": "a_later_kernel", "work": "flash_fwd"}]}))
    cell = "mistral7b.train.s2048"
    limits = json.loads(
        (pkg / "limits" / "mistral7b.train.s4096.json").read_text())
    (pkg / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench["workloads"].append({"name": cell, "config": "mistral-7b-v0.3",
                               "traffic": "train.b1.s2048", "chips": 1,
                               "why": "a later cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mistral7b.train.s4096" in m["workloads"]:
            m["workloads"].append(cell)
    bench["per_layer"].append(
        {"name": "train_steps_traced", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "train step",
         "moves": "train_tokens_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    ov = _tiny.overrides(cell)
    ov["traffic"] = {"batch": 1, "seq": 16, "trace_steps": 2}
    import time
    line = run_cell(tmp_path, cell, 3, 0.3, True, "cpu", time.perf_counter(),
                    overrides=ov, emit=lambda m: None)
    assert line["metrics"]["train_steps_traced"]["value"] == 2.0
    line = run_cell(tmp_path, cell, 3, 0.3, False, "cpu", time.perf_counter(),
                    overrides=ov, emit=lambda m: None)
    assert {"train_tokens_per_s", "setup_s"} <= set(line["metrics"])
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
