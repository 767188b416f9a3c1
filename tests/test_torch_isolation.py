"""The port stands alone: importing it loads neither jax nor any
``ray_tpu`` module, its entry points default to the CUDA device and
refuse to run on the CPU silently, and a kernel wrapper given a
non-CPU tensor launches its kernel or raises; it never falls back to its
plain version."""

import ast
import inspect
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
                "ray_tpu_torch.models.llama", "ray_tpu_torch.ops.attention",
                "ray_tpu_torch.ops.flash_attention",
                "ray_tpu_torch.ops.paged_attention",
                "ray_tpu_torch.llm.model", "ray_tpu_torch.llm.kvcache",
                "ray_tpu_torch.llm.engine", "ray_tpu_torch.llm.spec",
                "ray_tpu_torch.llm.pd", "ray_tpu_torch.parallel",
                "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.config",
                "ray_tpu_torch.util.events", "ray_tpu_torch.util.metrics",
                "ray_tpu_torch.util.tracing", "ray_tpu_torch.util.devmon",
                "ray_tpu_torch.util.forensics", "ray_tpu_torch.serve.fault"]


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
    # the training path: K1 with lse under autograd, K2 and K3
    qg = torch.empty((1, 8, 2, 64), device="meta", requires_grad=True)
    with pytest.raises(_build.KernelBuildError):
        flash_attention(qg, q, q)
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
