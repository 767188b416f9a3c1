"""The port stands alone: importing it loads neither jax nor any
``ray_tpu`` module, its entry points default to the CUDA device and
refuse to run on the CPU silently, and a kernel wrapper given a
non-CPU tensor launches its kernel or raises; it never falls back to its
plain version."""

import ast
import inspect
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch import bridge
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.llm import kvcache
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.parallel import make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_MODULES = ["ray_tpu_torch", "ray_tpu_torch.bridge",
                "ray_tpu_torch.models.llama", "ray_tpu_torch.models.moe",
                "ray_tpu_torch.ops.attention",
                "ray_tpu_torch.ops.flash_attention",
                "ray_tpu_torch.ops.paged_attention",
                "ray_tpu_torch.ops.ring_attention",
                "ray_tpu_torch.llm.model", "ray_tpu_torch.llm.kvcache",
                "ray_tpu_torch.llm.engine", "ray_tpu_torch.llm.spec",
                "ray_tpu_torch.llm.pd", "ray_tpu_torch.parallel",
                "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.tp",
                "ray_tpu_torch.config",
                "ray_tpu_torch.util.events", "ray_tpu_torch.util.metrics",
                "ray_tpu_torch.util.tracing", "ray_tpu_torch.util.devmon",
                "ray_tpu_torch.util.forensics", "ray_tpu_torch.serve",
                "ray_tpu_torch.serve.api", "ray_tpu_torch.serve.autoscale",
                "ray_tpu_torch.serve.batching", "ray_tpu_torch.serve.chaos",
                "ray_tpu_torch.serve.controller",
                "ray_tpu_torch.serve.fault", "ray_tpu_torch.serve.handle",
                "ray_tpu_torch.serve.llm", "ray_tpu_torch.serve.multiplex",
                "ray_tpu_torch.serve.proxy", "ray_tpu_torch.serve.replica",
                "ray_tpu_torch.api", "ray_tpu_torch.node",
                "ray_tpu_torch.scripts", "ray_tpu_torch.cluster_utils",
                "ray_tpu_torch.runtime", "ray_tpu_torch.runtime.agent",
                "ray_tpu_torch.runtime.cgroup",
                "ray_tpu_torch.runtime.control", "ray_tpu_torch.runtime.core",
                "ray_tpu_torch.runtime.device_store",
                "ray_tpu_torch.runtime.ids",
                "ray_tpu_torch.runtime.object_store",
                "ray_tpu_torch.runtime.persistence",
                "ray_tpu_torch.runtime.rpc",
                "ray_tpu_torch.runtime.runtime_env",
                "ray_tpu_torch.runtime.serialization",
                "ray_tpu_torch.runtime.worker",
                "ray_tpu_torch.util.accelerators", "ray_tpu_torch.util.aio",
                "ray_tpu_torch.util.health", "ray_tpu_torch.util.state",
                "ray_tpu_torch.util.timeseries", "ray_tpu_torch.util.tpu",
                "ray_tpu_torch.dag", "ray_tpu_torch.dag.ring",
                "ray_tpu_torch.dag.tuner",
                "ray_tpu_torch.dag.channel", "ray_tpu_torch.dag.runtime",
                "ray_tpu_torch._native", "ray_tpu_torch.data",
                "ray_tpu_torch.data.block", "ray_tpu_torch.data.dataset",
                "ray_tpu_torch.data.datasource",
                "ray_tpu_torch.data.iterator", "ray_tpu_torch.data.llm",
                "ray_tpu_torch.data.shuffle", "ray_tpu_torch.data.tfrecord",
                "ray_tpu_torch.util.joblib_backend",
                "ray_tpu_torch.util.actor_pool", "ray_tpu_torch.util.queue",
                "ray_tpu_torch.util.multiprocessing",
                "ray_tpu_torch.train", "ray_tpu_torch.train.api",
                "ray_tpu_torch.train.checkpoint",
                "ray_tpu_torch.train.collective",
                "ray_tpu_torch.train.zero",
                "ray_tpu_torch.train.ckptio",
                "ray_tpu_torch.train.controller",
                "ray_tpu_torch.train.mirror",
                "ray_tpu_torch.train.pipeline",
                "ray_tpu_torch.train.reshard",
                "ray_tpu_torch.train.trainer", "ray_tpu_torch.train.worker",
                "ray_tpu_torch.util.goodput", "ray_tpu_torch.util.storage",
                "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.appo",
                "ray_tpu_torch.rllib.bc", "ray_tpu_torch.rllib.dqn",
                "ray_tpu_torch.rllib.env", "ray_tpu_torch.rllib.impala",
                "ray_tpu_torch.rllib.multi_agent",
                "ray_tpu_torch.rllib.nets", "ray_tpu_torch.rllib.ppo",
                "ray_tpu_torch.rllib.rollout", "ray_tpu_torch.rllib.sac",
                "ray_tpu_torch.tune", "ray_tpu_torch.tune.schedulers",
                "ray_tpu_torch.tune.search", "ray_tpu_torch.tune.tuner",
                "ray_tpu_torch.train.boosting",
                "ray_tpu_torch.util.dashboard",
                "ray_tpu_torch.util.profiling",
                "ray_tpu_torch.util.collective",
                "ray_tpu_torch.autoscaler", "ray_tpu_torch.job_submission",
                "ray_tpu_torch.version"]


def test_import_leaves_jax_and_ray_tpu_out():
    """Every port module, the observability planes included, imports
    without loading jax, ml_dtypes or any ray_tpu module."""
    code = (
        "import sys, importlib\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes') "
        "or m.startswith(('jax.', 'ml_dtypes.')) or m == 'ray_tpu' or "
        "m.startswith('ray_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_host_libraries_leave_jax_and_ray_tpu_out():
    """In a fresh process with a cluster serving the metrics endpoint
    (``metrics_port=0``): a Tune sweep under ASHA, a boosted model, a
    profile and an autopsy over the control plane, the dashboard's pages
    and the CLI's ``main`` leave jax, ml_dtypes and every ray_tpu module
    out of ``sys.modules``."""
    code = (
        "import os, sys, tempfile, urllib.request\n"
        "import numpy as np\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import api, scripts, tune\n"
        "from ray_tpu_torch.train import BoostingConfig, BoostingTrainer\n"
        "os.environ['RAY_TPU_FORENSICS_DIR'] = tempfile.mkdtemp()\n"
        "rt.init(num_cpus=4, system_config={'metrics_port': 0})\n"
        "def fn(config):\n"
        "    for i in range(3):\n"
        "        tune.report({'loss': config['x'] * (i + 1)})\n"
        "grid = tune.Tuner(fn, param_space={'x': tune.grid_search([1, 9])},\n"
        "    tune_config=tune.TuneConfig(metric='loss', mode='min',\n"
        "        max_concurrent_trials=1, scheduler=tune.ASHAScheduler(\n"
        "            metric='loss', mode='min', grace_period=1, max_t=3,\n"
        "            reduction_factor=2))).fit()\n"
        "assert grid.get_best_result().config['x'] == 1\n"
        "X = np.random.default_rng(0).normal(size=(200, 3))\n"
        "BoostingTrainer(BoostingConfig(num_boost_round=2, num_workers=1),\n"
        "                (X, X[:, 0])).fit()\n"
        "addr = '%s:%d' % api._g.ctx.head_addr\n"
        "prof = scripts._call_head(addr, 'profile_target', timeout=30,\n"
        "    target=str(os.getpid()), duration_s=0.2, hz=50)\n"
        "assert prof.get('samples', 0) > 0, prof\n"
        "assert scripts._call_head(addr, 'autopsy', timeout=60)['path']\n"
        "host, port = api._g.head.metrics_addr\n"
        "for page in ('/', '/metrics', '/goodput', '/devices', '/profile'):\n"
        "    with urllib.request.urlopen(\n"
        "            'http://%s:%d%s' % (host, port, page), timeout=30) as r:\n"
        "        assert r.status == 200, page\n"
        "assert scripts.main(['status', '--address', addr]) == 0\n"
        "rt.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes') "
        "or m.startswith(('jax.', 'ml_dtypes.')) or m == 'ray_tpu' or "
        "m.startswith('ray_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_modules_list_every_module():
    """PORT_MODULES above names every module of the port."""
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             .removesuffix(".__init__")
             for p in (ROOT / "ray_tpu_torch").rglob("*.py")}
    listed = set(PORT_MODULES) | {"ray_tpu_torch.llm",
                                  "ray_tpu_torch.models",
                                  "ray_tpu_torch.ops", "ray_tpu_torch.serve",
                                  "ray_tpu_torch.util",
                                  "ray_tpu_torch._device",
                                  "ray_tpu_torch.ops._build"}
    assert found <= listed, sorted(found - listed)


def test_tp2_engine_leaves_jax_and_ray_tpu_out():
    """In a fresh process, a tensor-parallel engine over the CPU
    stand-in mesh (``parallel.tp.TensorMesh``) serves a request through
    its sharded prefill and decode: jax, ml_dtypes and every ray_tpu
    module stay out of ``sys.modules``."""
    code = (
        "import asyncio, sys, torch\n"
        "from ray_tpu_torch.llm.engine import LLMEngine\n"
        "from ray_tpu_torch.models import llama\n"
        "from ray_tpu_torch.parallel.tp import TensorMesh\n"
        "cfg = llama.tiny(dtype='float32', n_layers=1)\n"
        "m = llama.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')\n"
        "async def go():\n"
        "    eng = LLMEngine(cfg, m, mesh=TensorMesh(('cpu', 'cpu')),\n"
        "                    max_slots=2, max_len=64, prefill_buckets=(16,),\n"
        "                    cache_dtype='float32')\n"
        "    out = await eng.generate([1, 2, 3], max_new_tokens=4)\n"
        "    await eng.stop()\n"
        "    return out['tokens']\n"
        "assert len(asyncio.run(go())) == 4\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sharded_train_step_leaves_jax_and_ray_tpu_out():
    """In a fresh process, ``parallel.mesh`` over a (fsdp 2, tensor 2,
    context 2) mesh of CPU stand-ins takes a train step (the ring over
    the context axis, the fsdp gathers, the tensor reductions) and a
    batch from ``iter_device_batches(sharding=mesh)``: jax, ml_dtypes and
    every ray_tpu module stay out of ``sys.modules``."""
    code = (
        "import sys, numpy as np, torch\n"
        "from ray_tpu_torch import data\n"
        "from ray_tpu_torch.models import llama\n"
        "from ray_tpu_torch.parallel import MeshSpec, make_mesh, mesh\n"
        "cfg = llama.tiny(dtype='float32', n_layers=1)\n"
        "m = make_mesh(MeshSpec(fsdp=2, tensor=2, context=2),\n"
        "              devices=('cpu',) * 8)\n"
        "init_fn, step_fn = mesh.make_train_step(cfg, m)\n"
        "state = init_fn(torch.Generator().manual_seed(0))\n"
        "t = np.arange(4 * 17).reshape(4, 17) % cfg.vocab_size\n"
        "ds = data.from_numpy({'tokens': t[:, :-1], 'targets': t[:, 1:]})\n"
        "b = next(ds.iter_device_batches(batch_size=4, sharding=m))\n"
        "state, out = step_fn(state, b)\n"
        "assert torch.isfinite(out['loss'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_ring_round_and_zero_step_leave_jax_optax_and_ray_tpu_out():
    """In a fresh process, one allreduce round of the chunked ring over
    three ranks (shm channels, one thread each) and one ZeRO-1 step of
    ``train.ShardedOptimizer`` over ``parallel.ShardAdamW`` on two
    ranks, with bf16 torch parameters and gradients and the bf16
    parameter wire: jax, ml_dtypes, optax and every ray_tpu module stay
    out of ``sys.modules``."""
    code = (
        "import sys, numpy as np, torch\n"
        "from concurrent.futures import ThreadPoolExecutor\n"
        "from ray_tpu_torch.dag.channel import ShmRingChannel\n"
        "from ray_tpu_torch.dag.ring import RingReducer\n"
        "from ray_tpu_torch.parallel import ShardAdamW, default_optimizer\n"
        "from ray_tpu_torch.train.zero import ShardedOptimizer\n"
        "def ring(n):\n"
        "    chs = [ShmRingChannel(create=True, nslots=4,\n"
        "                          slot_bytes=1 << 16) for _ in range(n)]\n"
        "    return chs, [RingReducer(chs[r], ShmRingChannel.attach(\n"
        "        chs[(r - 1) % n].spec()), rank=r, size=n, op='mean',\n"
        "        timeout_s=30) for r in range(n)]\n"
        "def run(reds, fn):\n"
        "    with ThreadPoolExecutor(len(reds)) as ex:\n"
        "        return list(ex.map(fn, reds))\n"
        "chs, reds = ring(3)\n"
        "out = run(reds, lambda r: r.reduce(np.full(5000, r.rank,\n"
        "                                           np.float32)))\n"
        "assert all(np.all(o == 1.0) for o in out)\n"
        "opt = default_optimizer(1e-2, warmup_steps=1, total_steps=10)\n"
        "p = {'w': torch.ones(300, 7, dtype=torch.bfloat16)}\n"
        "def step(r):\n"
        "    so = ShardedOptimizer(ShardAdamW(opt, device='cpu'), group=r,\n"
        "                          param_wire_dtype='bfloat16')\n"
        "    st = so.init(p)\n"
        "    g = {'w': torch.full((300, 7), r.rank + 1.0,\n"
        "                         dtype=torch.bfloat16)}\n"
        "    return so.update(g, st, p)[0]['w']\n"
        "chs2, reds2 = ring(2)\n"
        "a, b = run(reds2, step)\n"
        "assert a.dtype == torch.bfloat16 and torch.equal(a, b)\n"
        "for c in chs + chs2:\n"
        "    c.close(); c.unlink()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'optax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_elastic_reshape_leaves_jax_optax_and_ray_tpu_out():
    """In a fresh process, the 3 -> 2 elastic reshape of
    ``tests/_torch_reshape.py``: three ranks' ZeRO-1 steps over
    ``ShardAdamW`` with peer mirrors crossing by pickle through shared
    memory, ``apply_rewire``, ``await_regroup`` and ``reshard`` over a
    fresh 2-ring, bitwise data movement: jax, ml_dtypes, optax and every
    ray_tpu module stay out of ``sys.modules``."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_reshape as t\n"
        "t.check_bitwise(*t.reshape_3_to_2(mirror=True))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'optax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pipeline_step_leaves_jax_optax_and_ray_tpu_out():
    """In a fresh process, two steps of a two-stage pipeline (the stage
    loops on threads over ``wire_local``'s shm channels, the device
    transport, torch stages, the ZeRO code path over ``ShardAdamW``):
    jax, ml_dtypes, optax and every ray_tpu module stay out of
    ``sys.modules``."""
    code = (
        "import sys, threading, numpy as np, torch\n"
        "from ray_tpu_torch.dag.channel import DATA, STOP\n"
        "from ray_tpu_torch.dag.runtime import pipe_exec_loop\n"
        "from ray_tpu_torch.parallel import ShardAdamW, default_optimizer\n"
        "from ray_tpu_torch.runtime.serialization import loads_oob, "
        "serialize\n"
        "from ray_tpu_torch.train import pipeline as pl\n"
        "specs, ins, res, chans = pl.wire_local(2, 2, device=True)\n"
        "opt = ShardAdamW(default_optimizer(1e-2, warmup_steps=1,\n"
        "                                   total_steps=10), device='cpu')\n"
        "s0 = pl.PipelineStageActor(lambda p, x: torch.tanh(x @ p),\n"
        "    torch.ones(4, 3), optimizer=opt, zero='local', device='cpu')\n"
        "s1 = pl.PipelineStageActor(lambda p, h: (h @ p).square().mean(),\n"
        "    torch.ones(3, 1), optimizer=opt, zero='local', device='cpu',\n"
        "    is_last=True)\n"
        "ts = [threading.Thread(target=pipe_exec_loop, args=(a, sp[0]))\n"
        "      for a, sp in zip((s0, s1), specs)]\n"
        "for t in ts: t.start()\n"
        "for _ in range(2):\n"
        "    for i in range(2):\n"
        "        ins[0].write(serialize(torch.full((2, 4), i + 1.0)), DATA)\n"
        "    kinds = [r[0].read_bytes(30)[0] for r in res]\n"
        "    assert kinds == [DATA, DATA], kinds\n"
        "ins[0].write(b'', STOP)\n"
        "for r in res: assert r[0].read_bytes(30)[0] == STOP\n"
        "for t in ts: t.join(30)\n"
        "assert s1.step_count == 2 and s0.params.dtype == torch.float32\n"
        "for c in chans:\n"
        "    c.close(); c.unlink()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'optax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pipeline_stage_defaults_to_cuda(monkeypatch):
    """A ``PipelineStageActor`` without ``device=`` puts its parameters
    on the card, so with no CUDA it raises instead of training on the
    CPU."""
    from ray_tpu_torch.train.pipeline import PipelineStageActor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineStageActor(lambda p, x: x @ p, torch.ones(2, 2))
    assert PipelineStageActor(lambda p, x: x @ p, torch.ones(2, 2),
                              device="cpu").params.device.type == "cpu"


def test_runtime_leaves_jax_and_ray_tpu_out():
    """In a fresh process, ``ray_tpu_torch.init()``, a task and an actor
    call load neither jax, ml_dtypes nor any ray_tpu module, in the
    driver or in the workers; the runtime itself does not import torch
    either, in the driver or in a worker whose task never asks for it."""
    code = (
        "import sys\n"
        "import ray_tpu_torch as rt\n"
        "def bad():\n"
        "    import sys\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu', 'torch'))\n"
        "rt.init(num_cpus=2)\n"
        "@rt.remote\n"
        "def task():\n"
        "    return bad()\n"
        "@rt.remote\n"
        "class A:\n"
        "    def m(self):\n"
        "        return bad()\n"
        "out = rt.get([task.remote(), A.remote().m.remote()], timeout=120)\n"
        "rt.shutdown()\n"
        "print([bad()] + out)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[[], [], []]"


def test_dag_and_data_import_leave_jax_torch_and_pandas_out():
    """Importing the compiled DAG and the datasets (``data.llm``
    included) loads neither jax, ml_dtypes nor any ray_tpu module, and
    no torch, pandas or pyarrow either: a map task or a DAG stage loads
    them only if its own function does."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.dag, ray_tpu_torch.dag.runtime\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.llm\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu', 'torch',\n"
        "              'pandas', 'pyarrow')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_dag_and_map_batches_workers_leave_jax_and_ray_tpu_out():
    """In a fresh cluster, a compiled DAG of two stages that stage a
    torch tensor between them, and a dataset ``map_batches`` fanned out
    to tasks: no worker (and not the driver) loads jax, ml_dtypes or any
    ray_tpu module."""
    code = (
        "import numpy as np\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import data\n"
        "from ray_tpu_torch.dag import InputNode, compile\n"
        "def bad():\n"
        "    import sys\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu'))\n"
        "rt.init(num_cpus=4)\n"
        "@rt.remote\n"
        "class A:\n"
        "    def f(self, x):\n"
        "        import torch\n"
        "        return {'t': torch.ones(3, dtype=torch.bfloat16) * x,\n"
        "                'bad': bad()}\n"
        "@rt.remote\n"
        "class B:\n"
        "    def g(self, d):\n"
        "        return [d['bad'], bad(), float(d['t'].float().sum())]\n"
        "a, b = A.remote(), B.remote()\n"
        "with InputNode() as inp:\n"
        "    out = b.g.bind(a.f.bind(inp))\n"
        "cd = compile(out)\n"
        "got = cd.execute(2).get(timeout=120)\n"
        "cd.teardown()\n"
        "assert got[2] == 6.0, got\n"
        "def mark(b):\n"
        "    return {'id': b['id'], 'bad': np.array([','.join(bad())]\n"
        "                                          * len(b['id']))}\n"
        "rows = data.range(40).map_batches(mark, batch_size=10,\n"
        "                                  concurrency=2).take_all()\n"
        "rt.shutdown()\n"
        "marks = sorted({str(r['bad']) for r in rows})\n"
        "print([bad(), got[0], got[1], marks])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[[], [], [], ['']]"


def test_train_worker_leaves_jax_and_ray_tpu_out():
    """In a fresh process, a TorchTrainer whose train_fn takes a step of
    the port's make_train_step and saves a checkpoint: neither the
    driver nor the train worker loads jax, ml_dtypes or any ray_tpu
    module."""
    code = (
        "import sys, tempfile\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import train\n"
        "def bad():\n"
        "    import sys\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('jax', 'jaxlib', 'ml_dtypes', 'ray_tpu'))\n"
        "def train_fn():\n"
        "    import torch\n"
        "    from ray_tpu_torch.models import llama\n"
        "    from ray_tpu_torch.parallel import mesh\n"
        "    from ray_tpu_torch.train import ckptio\n"
        "    cfg = llama.tiny(dtype='float32', n_layers=1)\n"
        "    init_fn, step_fn = mesh.make_train_step(cfg, device='cpu')\n"
        "    state = init_fn(torch.Generator().manual_seed(0))\n"
        "    toks = torch.randint(0, cfg.vocab_size, (1, 9))\n"
        "    state, m = step_fn(state, {'tokens': toks[:, :-1],\n"
        "                               'targets': toks[:, 1:]})\n"
        "    ck = ckptio.AsyncCheckpointer()\n"
        "    ck.save(1, *mesh.state_to_numpy(state), block=True)\n"
        "    ck.close()\n"
        "    train.report({'bad': bad()})\n"
        "rt.init(num_cpus=2)\n"
        "res = train.TorchTrainer(train_fn, run_config=train.RunConfig(\n"
        "    storage_path=tempfile.mkdtemp())).fit()\n"
        "rt.shutdown()\n"
        "assert res.error is None, res.error\n"
        "print([bad(), res.metrics['bad']])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[[], []]"


# Loaded at every interpreter start of the serve and RL tests' clusters
# (through PYTHONPATH): a thread writes the process's module names to
# $MODULES_DIR/<pid>.txt five times a second, and "<cuda-initialized>"
# once torch has initialised CUDA in it.
MODULE_DUMP = """\
import os, sys, threading, time

def _cuda_initialized():
    cuda = getattr(sys.modules.get("torch"), "cuda", None)
    return cuda is not None and cuda.is_initialized()

def _dump():
    path = os.path.join(os.environ["MODULES_DIR"], f"{os.getpid()}.txt")
    while True:
        names = sorted(sys.modules)
        if _cuda_initialized():
            names.append("<cuda-initialized>")
        with open(path + ".tmp", "w") as f:
            f.write("\\n".join(names))
        os.replace(path + ".tmp", path)
        time.sleep(0.2)

threading.Thread(target=_dump, daemon=True).start()
"""


def test_serve_processes_leave_jax_and_ray_tpu_out(tmp_path):
    """A fresh cluster serving a tiny ``build_llm_deployment`` app on the
    CPU, called through its handle and through the proxy: no process of
    it (driver, controller, proxy, replica, the runtime's own) loads
    jax, ml_dtypes or any ray_tpu module, and the controller and the
    proxy load no torch either. Each process reports its modules
    through a ``sitecustomize`` on PYTHONPATH."""
    dumps, env = _dump_env(tmp_path)
    code = (
        "import json, http.client, time\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import serve\n"
        "from ray_tpu_torch.serve.llm import LLMConfig, "
        "build_llm_deployment\n"
        "serve.api.DEFAULT_HTTP_PORT = 0\n"
        "rt.init(num_cpus=4)\n"
        "cfg = LLMConfig(model='tiny', model_overrides=dict(n_layers=1, "
        "dtype='float32'), max_slots=2, max_len=64, prefill_buckets=(16,), "
        "cache_dtype='float32', device='cpu')\n"
        "h = serve.run(build_llm_deployment(cfg), name='iso')\n"
        "out = rt.get(h.generate.remote([1, 2, 3], max_new_tokens=4), "
        "timeout=120)\n"
        "a = serve.proxy_address()\n"
        "c = http.client.HTTPConnection(a['host'], a['port'], timeout=60)\n"
        "c.request('POST', '/LLMServer', body=json.dumps({'tokens': [1, 2, "
        "3], 'max_new_tokens': 4}), headers={'Content-Type': "
        "'application/json'})\n"
        "r = c.getresponse()\n"
        "assert r.status == 200 and json.loads(r.read())['tokens'] == "
        "out['tokens']\n"
        "time.sleep(1.0)\n"
        "serve.shutdown()\n"
        "rt.shutdown()\n"
        "import os; print(os.getpid())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    driver = out.stdout.split()[-1]
    procs = {p.stem: set(p.read_text().split())
             for p in dumps.glob("*.txt")}

    def role(pid, mods):
        # the driver imports the controller's and the proxy's classes to
        # create them, and the controller the replica's; a replica is the
        # process that built the engine
        if pid == driver:
            return "driver"
        if "ray_tpu_torch.llm.engine" in mods:
            return "replica"
        for name in ("controller", "proxy"):
            if f"ray_tpu_torch.serve.{name}" in mods:
                return name
        return None
    roles = {pid: role(pid, m) for pid, m in procs.items()}
    assert {"controller", "proxy", "replica"} <= set(roles.values()), roles
    for pid, mods in procs.items():
        bad = sorted(m for m in mods if m.split(".")[0] in
                     ("jax", "jaxlib", "ml_dtypes", "ray_tpu"))
        assert bad == [], (pid, roles[pid], bad)
        if roles[pid] in ("controller", "proxy"):
            assert "torch" not in mods, (pid, roles[pid])


def _dump_env(tmp_path):
    site = tmp_path / "site"
    dumps = tmp_path / "modules"
    site.mkdir()
    dumps.mkdir()
    (site / "sitecustomize.py").write_text(MODULE_DUMP)
    env = dict(os.environ, MODULES_DIR=str(dumps),
               PYTHONPATH=os.pathsep.join(
                   [str(site), str(ROOT)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return dumps, env


def test_rl_iteration_leaves_jax_optax_and_ray_tpu_out(tmp_path):
    """A fresh cluster and one PPO iteration with one env runner, the
    learner on the CPU: neither the driver nor the runner process loads
    jax, optax, ml_dtypes or any ray_tpu module, and the runner never
    initialises CUDA (its policy steps are CPU work by design). Each
    process reports its modules through a ``sitecustomize`` on
    PYTHONPATH."""
    dumps, env = _dump_env(tmp_path)
    code = (
        "import os, time\n"
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch.rllib import PPO, PPOConfig\n"
        "rt.init(num_cpus=2)\n"
        "algo = PPO(PPOConfig(num_env_runners=1, num_envs_per_runner=4,\n"
        "                     rollout_len=16, hidden=(8, 8), device='cpu'))\n"
        "res = algo.train()\n"
        "assert res['timesteps_this_iter'] == 64, res\n"
        "time.sleep(1.0)\n"
        "rt.shutdown()\n"
        "print(os.getpid())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    driver = out.stdout.split()[-1]
    procs = {p.stem: set(p.read_text().split())
             for p in dumps.glob("*.txt")}
    runners = [pid for pid, mods in procs.items() if pid != driver
               and "ray_tpu_torch.rllib.ppo" in mods]
    assert driver in procs and len(runners) == 1, sorted(procs)
    for pid in [driver] + runners:
        bad = sorted(m for m in procs[pid] if m.split(".")[0] in
                     ("jax", "jaxlib", "ml_dtypes", "optax", "ray_tpu"))
        assert bad == [], (pid, bad)
    assert "<cuda-initialized>" not in procs[runners[0]]
    assert "torch" in procs[runners[0]]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py", *(ROOT / "ray_tpu_torch").rglob("*.py")]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ray_tpu", "optax",
                           "ml_dtypes"), \
            f"{path.name} imports {name}"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no.*available|none is"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = llama.tiny(dtype="float32")
    model = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(cfg, model)


def test_model_entry_points_default_to_cuda(monkeypatch):
    """``init_params``, ``params_from_numpy`` and ``make_train_step``'s
    ``init_fn`` without ``device=`` build on the card, so with no CUDA
    they raise instead of building a CPU model; a generator on another
    kind of device than the weights is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.tiny(dtype="float32", n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(torch.Generator().manual_seed(0), cfg)
    tree = bridge.params_to_numpy(
        llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_numpy(tree, cfg, trainable=True)
    init_fn, _ = make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        llama.init_params(torch.Generator().manual_seed(0), cfg, "meta")


def test_paged_decode_default_impl_is_the_kernel_on_cuda():
    for fn in (kvcache.paged_decode_steps, kvcache._paged_decode_core):
        assert inspect.signature(fn).parameters["impl"].default == "auto"
    assert kvcache.resolve_attn_impl("auto", "cuda") == "paged_flash"
    assert kvcache.resolve_attn_impl("auto", "cpu") == "gather"
    assert kvcache.resolve_attn_impl("gather", "cuda") == "gather"


def test_build_command_targets_sm_90a():
    for name in _build.SIGNATURES:
        cmd = _build.nvcc_command(name, pathlib.Path("out.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-O3" in cmd and "-shared" in cmd
        assert str(_build.source(name)) == cmd[-1]
        assert _build.source(name).exists()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "ray_tpu_torch/_build/" in ignored


def test_wrappers_never_fall_back_off_cpu(monkeypatch, tmp_path):
    """A tensor that is not on the CPU goes to the kernel: with no nvcc
    the build raises instead of the plain version answering."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        flash_attention(q, q, q)
    before = paged_attention.launches
    qd = torch.empty((1, 2, 2, 64), device="meta")
    pool = torch.empty((4, 16, 2, 64), device="meta")
    tables = torch.empty((1, 4), dtype=torch.int32, device="meta")
    lengths = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(_build.KernelBuildError):
        paged_attention(qd, pool, pool, tables, lengths)
    assert paged_attention.launches == before
    # the training path: K1 with lse (the op's body; under autograd a
    # meta tensor gets the op's fake, shapes only, and no launch), K2, K3
    import ray_tpu_torch.ops.attention as TA
    with pytest.raises(_build.KernelBuildError):
        TA._flash_fwd_lse(q, q, q, True, None)
    qg = torch.empty((1, 8, 2, 64), device="meta", requires_grad=True)
    before = fa.flash_attention_fwd.lse_launches
    assert flash_attention(qg, q, q).shape == q.shape
    assert fa.flash_attention_fwd.lse_launches == before
    lse = torch.empty((1, 2, 8), device="meta")
    before = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    for kernel in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(_build.KernelBuildError):
            kernel(q, q, q, q, lse, lse)
    with pytest.raises(_build.KernelBuildError):
        fa.flash_attention_bwd(q, q, q, q, q, lse)
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == before


def test_wrapper_checks_shapes_and_dtypes():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.empty((1, 8, 2, 48), device="meta"),
                        torch.empty((1, 8, 2, 48), device="meta"),
                        torch.empty((1, 8, 2, 48), device="meta"))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    qd = torch.empty((1, 2, 2, 64), device="meta")
    pool = torch.empty((4, 12, 2, 64), device="meta")
    tables = torch.empty((1, 4), dtype=torch.int32, device="meta")
    lengths = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="block_size"):
        paged_attention(qd, pool, pool, tables, lengths)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(qd, pool, pool, tables.long(), lengths)
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match=r"lse must be \(b, h, sq\)"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse[:, :1], lse)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_bwd_dkv(q, q, q, q.bfloat16(), lse, lse)


def test_build_hash_covers_every_included_header(monkeypatch, tmp_path):
    """Every quoted include of a kernel source is a header in csrc/ whose
    bytes key the library's path (hopper.cuh, flash_common.cuh), the
    sources need no include path beyond csrc/ and the toolkit's, and
    editing a header gives every library a new path."""
    import re
    for src in _build.CSRC.glob("*.cu"):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc.endswith(".cuh") and (_build.CSRC / inc).exists(), \
                (src.name, inc)
    for name in _build.SIGNATURES:
        assert not any(a.startswith("-I") for a in
                       _build.nvcc_command(name, pathlib.Path("o.so")))
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in _build.CSRC.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    before = {n: _build.library_path(n) for n in _build.SIGNATURES}
    with open(copy / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SIGNATURES}
    assert all(before[n] != after[n] for n in before)


def test_sass_counts_reads_cuobjdump_per_function(monkeypatch, tmp_path):
    """``sass_counts`` runs the toolkit's cuobjdump on the built library
    and counts an opcode per kernel function."""
    fake = tmp_path / "cuobjdump"
    fake.write_text(
        "#!/bin/sh\n"
        "echo '\tcode for sm_90a'\n"
        "echo '\t\tFunction : _ZN2tc22flash_fwd_kernel_wgmmaILi128EEEv'\n"
        "echo '        /*0040*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;'\n"
        "echo '        /*0050*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;'\n"
        "echo '\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEv'\n"
        "echo '        /*0040*/ FFMA R1, R2, R3, R4 ;'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    counts = _build.sass_counts("flash_attention_fwd")
    assert counts == {"_ZN2tc22flash_fwd_kernel_wgmmaILi128EEEv": 2,
                      "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi128EEEv": 0}


def test_bf16_wrappers_never_fall_back_off_cpu(monkeypatch, tmp_path):
    """The bf16 path folds q' and launches the wgmma kernels: with no
    nvcc a bf16 tensor off the CPU raises too, and counts no launch."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    q = torch.empty((1, 8, 2, 128), device="meta", dtype=torch.bfloat16)
    lse = torch.empty((1, 2, 8), device="meta")
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        fa.flash_attention_fwd(q, q, q, with_lse=True)
    with pytest.raises(_build.KernelBuildError):
        fa.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
    with pytest.raises(_build.KernelBuildError):
        fa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == before
