"""One run of one cell: the generator its traffic names, the metrics
that ``BENCHMARK.json`` lists for it, the comparison with its limits,
and the result line."""

from __future__ import annotations

import copy
import sys
import types
from pathlib import Path
from typing import Callable, Optional

from portbench.bench import model as bm
from portbench.bench import trace as tr_mod
from portbench.bench.manifest import Manifest, generator
from portbench.work import attention as work_attention
from portbench.work import flops as work_flops

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number compared at or
    under its limit (a NaN or a missing limit fails)."""
    checks, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": lim}
        if lim is None or not (value <= lim):
            ok = False
    return ok, checks


def reader_context(man: Manifest, trace, run: dict, spec, traffic: dict):
    """What a per-layer reader's ``read(ctx)`` sees: ``matched(set)``
    gives each entry of a kernel set with its traced operations."""
    return types.SimpleNamespace(
        trace=trace, run=run, spec=spec, traffic=traffic,
        matched=lambda name: tr_mod.matched(trace, man.kernel_set(name),
                                            name),
        work=work_attention, flops=work_flops, peaks=work_attention.PEAKS)


def read_per_layer(man: Manifest, cell: str, rctx) -> dict:
    """The cell's per-layer metrics. Each is listed for this cell, so its
    reader has to find something to read: one that returns nothing, or
    whose kernels or range the window does not hold, fails the run with
    the metric's layer; so does a share outside 0-100."""
    metrics = {}
    for m in man.per_layer(cell):
        where = f"{m['name']} (layer {m['layer']})"
        try:
            v = man.reader(m["name"])(rctx)
        except tr_mod.NothingToRead as e:
            raise RuntimeError(f"{where}: {e}") from e
        if v is None:
            raise RuntimeError(f"{where}: its reader found nothing to read "
                               "in the traced window")
        if m["unit"] == "%" and not 0.0 <= v <= 100.0:
            raise RuntimeError(
                f"{where} reads {v} %: a share outside 0-100 means its "
                "work or its time is miscounted")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             overrides: Optional[dict] = None,
             emit: Callable[[str], None] = log) -> dict:
    """Build, warm up, measure and check one cell; returns the result
    line's object."""
    import torch
    man = Manifest(root)
    cell = man.cell(cell_name)
    cfg, traffic = man.config(cell), man.traffic(cell)
    limits = man.limits(cell)
    if overrides:
        cfg = _merge(cfg, overrides.get("config", {}))
        traffic = _merge(traffic, overrides.get("traffic", {}))
    spec = bm.spec_from_config(cfg)
    dev = torch.device(device)
    ctx = types.SimpleNamespace(
        root=Path(root), cell=cell, spec=spec, traffic=traffic, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=dev,
        t_start=t_start, log=emit)
    res = generator(traffic["generator"]).run(ctx)
    metrics = {}
    if trace:
        if res["trace"] is None:
            raise RuntimeError("the traced run recorded no trace")
        metrics = read_per_layer(man, cell_name, reader_context(
            man, res["trace"], res["run"], spec, traffic))
    else:
        for m in man.end_to_end(cell_name):
            if m["name"] not in res["end_to_end"]:
                raise RuntimeError(f"the run measured no {m['name']}")
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    correct, checks = judge(res["numbers"], limits)
    if dev.type == "cuda":
        dinfo = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": int(cell["chips"])}
    else:
        dinfo = {"platform": dev.type, "kind": dev.type,
                 "count": int(cell["chips"])}
    dinfo["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dinfo}
    if trace and res["trace"] is not None:
        dinfo["busy_s"] = res["trace"].busy_s()
        dinfo["window_s"] = res["trace"].window_s
        line["breakdown"] = res["trace"].breakdown()
    line["checks"] = checks
    return line
