"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size; the benchmark's runs do not run this.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--fault 3] [--seconds 20] [--override JSON]
    python3 portbench/control.py --config-file portbench/configs/<c>.json \
        --traffic <mix> --seeds ...

The second form reads a configuration and a mix that no cell pairs yet;
``--override '{"config": {...}, "traffic": {...}}'`` changes keys of
either, as a witness at another precision or depth does.

For each seed it prints one JSON line with the numbers the run compares:
the program's (its sound runs give the lower reading), and on the first
``--control`` seeds the control's, the reference computed in float8 in
the program's place (it gives the upper reading). For a training cell
it also reads, on the first ``--fault`` seeds, the program fed half of
each batch (the mean taken over the rest). A serving cell runs its mix
for ``--seconds`` after the first round, as a run does, and reads the
same sample of requests. The last line sums them up: per number, the
largest sound reading and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)

from portbench.bench import env  # noqa: E402


def half(b: dict) -> dict:
    """Half of a batch: half of its rows, or of its one row's tokens."""
    n = b["tokens"].shape[0]
    if n > 1:
        return {k: v[: n // 2] for k, v in b.items()}
    s = b["tokens"].shape[1]
    return {k: v[:, : s // 2] for k, v in b.items()}


def _leaves(r: dict) -> dict:
    """Per-leaf norms of one side's readings, keyed by leaf name."""
    from portbench.bench import model as bm
    return {part: {bm.leaf_name(*leaf): v for leaf, v in r[part].items()}
            for part in ("first", "change")} | {"losses": r["losses"]}


def train_seed(ctx, control: bool, fault: bool, detail=None) -> dict:
    from portbench.generators import train_steps as ts
    from portbench.reference.control import CONTROL
    out = {}
    prog = ts.Program(ctx)
    sound = ts.program_readings(ctx, prog, lambda k: ts.batch(ctx, k))
    prog.free()
    del prog
    faulty = None
    if fault:
        prog = ts.Program(ctx)
        faulty = ts.program_readings(ctx, prog,
                                     lambda k: half(ts.batch(ctx, k)))
        prog.free()
        del prog
    ref = ts.reference_readings(ctx)
    out["program"], out["program_where"] = ts.compare(sound, ref)
    if faulty is not None:
        out["half_batch"], _ = ts.compare(faulty, ref)
    if control:
        ctl = ts.reference_readings(ctx, CONTROL)
        out["control"], out["control_where"] = ts.compare(ctl, ref)
    if detail is not None:
        rows = {"seed": ctx.seed, "program": _leaves(sound),
                "reference": _leaves(ref)}
        if faulty is not None:
            rows["half_batch"] = _leaves(faulty)
        if control:
            rows["control"] = _leaves(ctl)
        detail.write(json.dumps(rows) + "\n")
        detail.flush()
    return out


def serve_seed(ctx, control: bool) -> dict:
    from portbench.generators import closed_loop_engine as ce
    from portbench.reference.control import CONTROL
    eng = ce.build_engine(ctx)
    res = asyncio.run(ce._drive(ctx, eng, ctx.seconds, False))
    del eng
    ce.free(ctx.device)
    ok, failed = ce.window_requests(res)
    picked = ce.sample(ctx, ok)
    if not picked:
        # no request completed in the window: no reading, and no
        # control reading either (never a gap of 0)
        return {"completed": 0, "failed": len(failed)}
    gaps = ce.token_gaps(ctx, picked, [CONTROL] if control else [])
    out = {"program": {"token_gap": gaps["token_gap"]},
           "served_tokens": gaps["served_tokens"], "requests": len(picked),
           "completed": len(ok), "failed": len(failed)}
    if control:
        out["control"] = {"token_gap": gaps[CONTROL.name]}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--config-file")
    ap.add_argument("--traffic")
    ap.add_argument("--override", default="{}")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--detail", default=None,
                    help="a file for every leaf's readings (training)")
    args = ap.parse_args()
    env.setup(ROOT)
    import torch
    from portbench.bench import model as bm
    from portbench.bench.manifest import Manifest
    from portbench.bench.runner import _merge, foreign_modules, log
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA device")
    man = Manifest(ROOT)
    if args.workload:
        cell = man.cell(args.workload)
        cfg = man.config(cell)
    else:
        cell = {"name": f"{Path(args.config_file).stem}.{args.traffic}",
                "traffic": args.traffic, "chips": 1}
        cfg = json.loads((ROOT / args.config_file).read_text())
    over = json.loads(args.override)
    traffic = _merge(man.traffic(cell), over.get("traffic", {}))
    spec = bm.spec_from_config(_merge(cfg, over.get("config", {})))
    summary: dict = {}
    detail = open(args.detail, "w") if args.detail else None
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = types.SimpleNamespace(
            root=ROOT, cell=cell, spec=spec, traffic=traffic, seed=seed,
            seconds=args.seconds, trace=False, device=torch.device("cuda:0"),
            t_start=time.perf_counter(), log=log)
        if traffic["generator"] == "train_steps":
            out = train_seed(ctx, j < args.control, j < args.fault, detail)
        else:
            out = serve_seed(ctx, j < args.control)
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out, default=str), flush=True)
        for kind in ("program", "control", "half_batch"):
            for name, v in out.get(kind, {}).items():
                key = f"{kind}.{name}"
                pick = max if kind == "program" else min
                summary[key] = v if key not in summary else pick(summary[key], v)
    summary["foreign_modules"] = foreign_modules()
    print(json.dumps({"summary": summary, "workload": cell["name"],
                      "override": over,
                      "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
