"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs/<file>``)
and a traffic mix (``traffic/<traffic>.json``, whose ``generator`` names a
module of ``generators/``); its limits are ``limits/<cell>.json``; a
per-layer metric is read by ``metrics/<name>.py``; the kernels a layer's
reader counts are in every ``kernels/*.json`` whose ``set`` it names. A
later cell, mix, metric or kernel is a new file and a new entry, never an
edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    def __init__(self, root: Path, bench: Optional[dict] = None):
        self.root = Path(root)
        self.pkg = self.root / "portbench"
        self.bench = bench if bench is not None else json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = self.config_entry(cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads(
            (self.pkg / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads(
            (self.pkg / "limits" / f"{cell['name']}.json").read_text())

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self._applies(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.bench["per_layer"] if self._applies(m, cell)]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.pkg / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def kernel_set(self, name: str) -> List[dict]:
        """Every kernel entry of the ``kernels/*.json`` files of set
        ``name``."""
        out = []
        for f in sorted((self.pkg / "kernels").glob("*.json")):
            d = json.loads(f.read_text())
            if d.get("set") == name:
                out.extend(d["kernels"])
        return out


def generator(name: str):
    """The module ``generators/<name>.py``."""
    return importlib.import_module(f"portbench.generators.{name}")
