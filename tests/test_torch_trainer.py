"""TorchTrainer driving the port's make_train_step through the
controller and worker actors of the port's runtime, on the CPU.

- A tiny f32 Llama trained for 6 steps in a worker reports the losses
  and grad norms that the same 6 make_train_step steps give in this
  process, bit for bit (both sides on one CPU thread, so the f32 sums run
  in one order).
- The same run saving through AsyncCheckpointer at step 3 and killed
  once at step 4 (FailureConfig(max_failures=1)) restores from the
  manifest in a new worker and reports steps 4-6 equal to the
  uninterrupted run's.
- Two workers with torch_distributed=True join a gloo world at the
  controller's bootstrap and all_reduce across the process boundary (the
  counterpart of tests/test_jax_distributed.py).
- Two use_gpu workers of one host are pinned to a card each (the module's
  cluster advertises two GPU slots; no card is touched).
"""

import os
import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.config import Config
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)
from ray_tpu_torch.util.accelerators import peak_tflops

# the workers rebuild this module's train_fns from their bytes instead of
# importing the module
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STEPS = 6


@pytest.fixture(scope="module")
def cluster():
    cfg = Config.from_env(num_workers_prestart=0, max_workers_per_node=8,
                          default_max_task_retries=0)
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2.0}, config=cfg)
    yield
    ray_tpu_torch.shutdown()


def _setup():
    """The run both sides take: tiny f32 Llama (seed 0), AdamW at 1e-2
    with a 1-step warmup, one CPU thread."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    cfg = llama.tiny(dtype="float32", n_layers=2, remat_policy="dots")
    init_fn, step_fn = mesh.make_train_step(
        cfg, device="cpu", optimizer=mesh.default_optimizer(
            1e-2, warmup_steps=1, total_steps=10))
    return cfg, init_fn(torch.Generator().manual_seed(0)), step_fn


def _batch(cfg, step):
    toks = np.random.default_rng(step).integers(0, cfg.vocab_size, (2, 33))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _await_reports(run: str, n: int) -> None:
    """Block until the run's controller holds ``n`` reports: a worker
    that dies right after reporting must not race the poll that drains
    its reports."""
    ctrl = train.get_controller(run)
    while ray_tpu_torch.get(ctrl.status.remote(), timeout=60)["reports"] < n:
        time.sleep(0.05)


def _train_fn(config):
    """Steps 1..STEPS, resuming after the step the checkpoint holds;
    saves after ``save_at`` and dies once before ``fail_at`` (after the
    save is durable and the controller holds the reports so far),
    leaving ``marker`` behind."""
    from ray_tpu_torch.parallel import mesh
    from ray_tpu_torch.train import ckptio
    cfg, state, step_fn = _setup()
    ctx = train.get_context()
    start = 0
    if ctx.get_checkpoint() is not None:
        params, opt, start = ckptio.restore(
            *mesh.numpy_template(state), checkpoint=ctx.get_checkpoint())
        mesh.state_from_numpy(state, params, opt)
    ck = ckptio.AsyncCheckpointer() if "save_at" in config else None
    for step in range(start + 1, STEPS + 1):
        if step == config.get("fail_at") and \
                not os.path.exists(config["marker"]):
            ck.flush()
            _await_reports(config["run"], step - 1)
            open(config["marker"], "w").close()
            os._exit(1)
        with ctx.trace_step():
            state, m = step_fn(state, _batch(cfg, step))
            if step == config.get("save_at"):
                ck.save(step, *mesh.state_to_numpy(state))
        train.report({"step": step, "loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "resumed_from": start})
    if ck is not None:
        ck.flush()
        ck.close()


def _direct():
    """The same steps by make_train_step in this process."""
    threads = torch.get_num_threads()
    try:
        cfg, state, step_fn = _setup()
        out = []
        for step in range(1, STEPS + 1):
            state, m = step_fn(state, _batch(cfg, step))
            out.append((m["loss"].item(), m["grad_norm"].item()))
        return out
    finally:
        torch.set_num_threads(threads)


def _history(res):
    assert res.error is None, res.error
    return [(m["loss"], m["grad_norm"]) for m in res.metrics_history]


def test_trainer_losses_equal_direct_steps(cluster):
    res = TorchTrainer(_train_fn, train_loop_config={},
                       scaling_config=ScalingConfig(num_workers=1)).fit()
    assert res.error is None, res.error
    assert [m["step"] for m in res.metrics_history] == list(range(1, 7))
    assert _history(res) == _direct()


def test_checkpoint_failure_resume_equals_uninterrupted(cluster, tmp_path):
    marker = str(tmp_path / "died_once")
    res = TorchTrainer(
        _train_fn,
        train_loop_config={"save_at": 3, "fail_at": 4, "marker": marker,
                           "run": "resume-run"},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="resume-run", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert os.path.exists(marker)
    hist = res.metrics_history
    assert [m["step"] for m in hist] == list(range(1, 7))
    assert [m["resumed_from"] for m in hist] == [0, 0, 0, 3, 3, 3]
    assert _history(res) == _direct()
    assert os.path.isdir(tmp_path / "ckpt-00000003")


def test_two_worker_gloo_bootstrap_and_all_reduce(cluster):
    def train_fn():
        import torch
        import torch.distributed as dist
        from ray_tpu_torch import train as t
        # idempotent inside train_fn: the controller already joined
        assert t.ensure_torch_distributed() is True
        x = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(x)
        t.report({"world": dist.get_world_size(),
                  "rank": dist.get_rank(), "sum": x.item(),
                  "backend": dist.get_backend()})
        dist.destroy_process_group()

    res = TorchTrainer(train_fn, scaling_config=ScalingConfig(
        num_workers=2, torch_distributed=True)).fit()
    assert res.error is None, res.error
    assert res.metrics == {"world": 2, "rank": 0, "sum": 3.0,
                           "backend": "gloo"}


def test_auto_bootstrap_only_for_gpu_groups():
    assert ScalingConfig(num_workers=2).wants_torch_distributed() is False
    assert ScalingConfig(num_workers=1,
                         use_gpu=True).wants_torch_distributed() is False
    gpu = ScalingConfig(num_workers=2, use_gpu=True)
    assert gpu.wants_torch_distributed() is True
    assert gpu.worker_resources() == {"GPU": 1.0}
    with pytest.raises(ValueError):
        ScalingConfig(num_workers=2, torch_distributed="false")


def test_h100_peak():
    assert peak_tflops("NVIDIA H100 80GB HBM3") == 989.0


def test_gpu_workers_pinned_to_a_card_each(cluster, tmp_path):
    """Each use_gpu worker sees only the card of its LOCAL_RANK, set
    before its train_fn runs, so a host's workers never share cuda:0."""
    out = str(tmp_path)

    def train_fn():
        import os
        with open(os.path.join(out, os.environ["RANK"]), "w") as f:
            f.write(os.environ["LOCAL_RANK"] + " "
                    + os.environ["CUDA_VISIBLE_DEVICES"])

    res = TorchTrainer(train_fn, scaling_config=ScalingConfig(
        num_workers=2, use_gpu=True, torch_distributed=False)).fit()
    assert res.error is None, res.error
    seen = {r: open(os.path.join(out, r)).read() for r in ("0", "1")}
    assert seen == {"0": "0 0", "1": "1 1"}


def test_card_of_follows_the_node_visible_list(monkeypatch):
    from ray_tpu_torch.train.worker import _card_of
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert _card_of(3) == "3"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4, 6")
    assert [_card_of(0), _card_of(1)] == ["4", "6"]
    with pytest.raises(RuntimeError, match="no card of its own"):
        _card_of(2)
