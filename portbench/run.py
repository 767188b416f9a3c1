"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the program, ``ray_tpu_torch/``, on a machine with as
many CUDA cards as the cell asks for. It builds the cell from the seed,
warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of its output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiled
stretch. Progress and each number compared, beside its limit, go to
standard error. It exits with 2, printing no result, when the checkout
or the cards are not there, and with 3 when a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import env  # noqa: E402


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        fail(f"no BENCHMARK.json at {ROOT}")
    env.setup(ROOT)
    import importlib.util
    found = importlib.util.find_spec("ray_tpu_torch")
    if found is None or found.origin is None or \
            ROOT not in Path(found.origin).resolve().parents:
        fail(f"the program (ray_tpu_torch) is not in the checkout {ROOT}")
    from portbench.bench.manifest import Manifest
    try:
        cell = Manifest(ROOT).cell(args.workload)
    except KeyError as e:
        fail(str(e))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{args.workload} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} found")
    from portbench.bench.runner import foreign_modules, log, run_cell
    log(f"setup: interpreter, imports and the card's check "
        f"{time.perf_counter() - T_START:.3f} s")
    line = run_cell(ROOT, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda:0", T_START)
    bad = foreign_modules()
    if bad:
        fail("modules of JAX or of the JAX package were loaded: "
             + ", ".join(bad), 3)
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} against the limit "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)


if __name__ == "__main__":
    main()
