"""Tiny sizes of the benchmark's cells, for running the harness on the
CPU (the program's plain versions of its kernels)."""

import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIG = {"hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "intermediate_size": 128,
               "vocab_size": 512, "num_hidden_layers": 2,
               "max_position_embeddings": 256, "torch_dtype": "float32"}
TINY_TRAIN = {"batch": 2, "seq": 32, "trace_steps": 1}
TINY_SERVE = {"clients": 4, "prompt_tokens": {"low": 16, "high": 48},
              "output_tokens": {"low": 4, "high": 12}, "pool": {"size": 16},
              "engine": {"max_slots": 4, "max_len": 128,
                         "prefill_buckets": [16, 32]},
              "check": {"min_tokens": 20}, "trace_seconds": 0.3}
SEED = 2 ** 31 + 77


def overrides(cell: str, **config) -> dict:
    cfg = dict(TINY_CONFIG, **config)
    return {"config": cfg,
            "traffic": TINY_TRAIN if ".train." in cell else TINY_SERVE}


def run(cell: str, seconds: float = 1.0, trace: bool = False, root=ROOT,
        **config) -> dict:
    from portbench.bench.runner import run_cell
    return run_cell(root, cell, SEED, seconds, trace, "cpu",
                    time.perf_counter(), overrides=overrides(cell, **config),
                    emit=lambda msg: None)
