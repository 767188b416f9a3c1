"""Build and load the port's hand-written CUDA kernels.

Each source in ``ray_tpu_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, then loaded
with ctypes; one source may hold several kernels' entry points (the
backward pair K2/K3). The build runs at first use, into
``ray_tpu_torch/_build/`` (listed in ``.gitignore``), and is reused while
the hash of the source and the shared headers (``csrc/*.cuh``) is
unchanged. Nothing here runs at import time: a CPU-only install imports
the port without a CUDA toolkit, and only a kernel launch on a CUDA
tensor reaches the build. A build that fails raises; there is no
fallback. Each source actually compiled (not one whose library was
reused) is reported to the device monitor as one compile of
``<stem>.cu`` with its nvcc seconds (``util/devmon.record_compile``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

from ray_tpu_torch.util import devmon

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

# the kernels' C entry points: name -> (source stem in csrc/, symbol,
# argtypes as ctypes types)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "flash_attention_fwd": (
        "flash_attention_fwd", "ray_flash_attention_fwd",
        # q, k, v, o, lse, b, sq, sk, h, kvh, d, offset, causal, scale,
        # dtype, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd", "ray_flash_attention_bwd_dkv",
        # q, k, v, do, lse, delta, dk, dv, b, sq, sk, h, kvh, d, offset,
        # causal, scale, dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _F, _I, _P]),
    "flash_attention_bwd_dq": (
        "flash_attention_bwd", "ray_flash_attention_bwd_dq",
        # q, k, v, do, lse, delta, dq, b, sq, sk, h, kvh, d, offset,
        # causal, scale, dtype, stream; bf16 takes q' = fold_scale(q,
        # sm_scale) and scale = sm_scale, applied once to dQ'; f32 takes q
        # and sm_scale and folds q' itself
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
         _I, _P]),
    "paged_attention": (
        "paged_attention", "ray_paged_attention",
        # q, k_pool, v_pool, tables, lengths, part (f32 scratch of
        # slots * kvh * nsplit * g * (hd + 2)), counters (int32, slots *
        # kvh, zero), both null with one split; out, slots, kvh, g, hd,
        # bs, width, span, q_dtype, pool dtype, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _P]),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def source(name: str) -> Path:
    """The ``.cu`` source that holds kernel ``name``'s entry point."""
    return CSRC / f"{SIGNATURES[name][0]}.cu"


def library_path(name: str) -> Path:
    """Where the build of kernel ``name``'s source lives: keyed by the
    hash of the source, the shared headers and the target, so an edited
    source or header never reuses a stale library."""
    src = source(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(ARCH.encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    """The compile command for one kernel source (sm_90a, -O3, a shared
    library with a plain C interface)."""
    return [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(out),
            str(source(name))]


def _collect(proc: subprocess.Popen, t0: float):
    """(output, seconds since ``t0``) of one nvcc, once it exits."""
    log, _ = proc.communicate()
    return log, time.monotonic() - t0


class _Loader:
    """Process-wide cache of loaded kernel libraries; thread-safe (the
    engine launches kernels from executor threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}

    def build(self, names: Iterable[str]) -> Dict[str, str]:
        """Compile the source of every listed kernel whose library is
        missing, one nvcc per source, all started together, and record
        each compile with its own nvcc seconds. Returns each source
        stem's ptxas report (empty when the build was reused)."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        reports = {}
        for name in names:
            stem = source(name).stem
            out = library_path(name)
            if stem in reports:
                continue
            reports[stem] = ""
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = nvcc_command(name, tmp)
            try:
                t0 = time.monotonic()
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except FileNotFoundError as e:
                for _, _, p, _ in procs.values():
                    p.kill()
                    p.wait()
                raise KernelBuildError(
                    f"nvcc not found ({cmd[0]}): the CUDA kernels need "
                    "the CUDA toolkit") from e
            procs[stem] = (out, tmp, proc, t0)
        failed = []
        # one waiter per nvcc, so each compile's seconds are its own
        with ThreadPoolExecutor(max(1, len(procs))) as pool:
            waits = {stem: pool.submit(_collect, proc, t0)
                     for stem, (_, _, proc, t0) in procs.items()}
        for stem, (out, tmp, proc, _) in procs.items():
            log, seconds = waits[stem].result()
            reports[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}:\n{log}")
                continue
            os.replace(tmp, out)
            devmon.record_compile(f"{stem}.cu", seconds)
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
        return reports

    def load(self, name: str) -> ctypes.CDLL:
        stem = SIGNATURES[name][0]
        lib = self._libs.get(stem)
        if lib is not None:
            return lib
        with self._lock:
            lib = self._libs.get(stem)
            if lib is None:
                self.build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                for src, sym, argtypes in SIGNATURES.values():
                    if src == stem:
                        fn = getattr(lib, sym)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                self._libs[stem] = lib
        return lib


LOADER = _Loader()


def kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded on first
    use."""
    return getattr(LOADER.load(name), SIGNATURES[name][1])


def build_all() -> Dict[str, str]:
    """Build every kernel source in parallel (one nvcc each); returns
    each source stem's ptxas report."""
    return LOADER.build(SIGNATURES)


def sass_counts(name: str, opcode: str = "HGMMA") -> Dict[str, int]:
    """How many ``opcode`` instructions the SASS of each kernel function
    in kernel ``name``'s built library holds (``cuobjdump -sass``; HGMMA
    is ``wgmma`` on the tensor cores). Keys are the mangled names."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts.setdefault(fn, 0)
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {err}")
