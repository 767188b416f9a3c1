"""Runtime environments: per-task/actor worker environment isolation.

Scoped analog of the reference's runtime_env plugin system (reference:
python/ray/_private/runtime_env/plugin.py, runtime_env/agent/main.py):
supported fields are `env_vars`, `working_dir` (a local path the worker
chdirs into), `py_modules` (paths prepended to PYTHONPATH), and
`pip`/`uv` (extra packages in a CACHED per-requirements venv, reference:
_private/runtime_env/{pip,uv}.py). Workers are pooled PER runtime env —
a task never executes in a worker carrying another env's variables
(reference keys its worker pool the same way, raylet/worker_pool.cc
runtime_env_hash). pip/uv venvs are created with --system-site-packages
so the image's torch/ray_tpu_torch stay importable and only the delta installs;
cache lives under $RAY_TPU_VENV_CACHE (default ~/.cache/ray_tpu_torch/venvs)
keyed by the requirement set, so the second task with the same deps
pays nothing. conda/container stay rejected (image-level concerns on
hermetic TPU pods).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

SUPPORTED = ("env_vars", "working_dir", "py_modules", "pip", "uv")
UNSUPPORTED = ("conda", "container", "java_jars")


def _normalize_pkgs(v, field: str) -> List[str]:
    if isinstance(v, dict):
        v = v.get("packages", [])
    if isinstance(v, str):
        v = [v]
    if not isinstance(v, (list, tuple)) or \
            not all(isinstance(x, str) for x in v):
        raise ValueError(f"{field} must be a list of requirement "
                         f"strings (or {{'packages': [...]}})")
    return sorted(set(v))


def validate(runtime_env: Optional[dict]) -> Optional[dict]:
    """Normalize + validate; returns a canonical dict or None."""
    if not runtime_env:
        return None
    bad = [k for k in runtime_env if k in UNSUPPORTED]
    if bad:
        raise ValueError(
            f"runtime_env fields {bad} are not supported (image-level "
            f"concerns — bake them into the pod image); supported: "
            f"{list(SUPPORTED)}")
    unknown = [k for k in runtime_env if k not in SUPPORTED]
    if unknown:
        raise ValueError(f"unknown runtime_env fields {unknown}; "
                         f"supported: {list(SUPPORTED)}")
    out = {}
    if runtime_env.get("pip") and runtime_env.get("uv"):
        raise ValueError("specify pip OR uv, not both")
    for field in ("pip", "uv"):
        if runtime_env.get(field):
            pkgs = _normalize_pkgs(runtime_env[field], field)
            if pkgs:
                out[field] = pkgs
    ev = runtime_env.get("env_vars")
    if ev:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in ev.items()):
            raise ValueError("env_vars must be Dict[str, str]")
        out["env_vars"] = dict(sorted(ev.items()))
    wd = runtime_env.get("working_dir")
    if wd:
        if not wd.startswith(PKG_PREFIX):
            wd = os.path.abspath(wd)
            if not os.path.isdir(wd):
                raise ValueError(f"working_dir {wd!r} is not a directory")
        out["working_dir"] = wd
    mods = runtime_env.get("py_modules")
    if mods:
        mods = [m if m.startswith(PKG_PREFIX) else os.path.abspath(m)
                for m in mods]
        for m in mods:
            if not m.startswith(PKG_PREFIX) and not os.path.exists(m):
                raise ValueError(f"py_modules path {m!r} does not exist")
        out["py_modules"] = sorted(mods)
    return out or None


def merge(base: Optional[dict], override: Optional[dict]) -> Optional[dict]:
    """Job-level base + task-level override (override's env_vars win)."""
    if not base:
        return override
    if not override:
        return base
    out = dict(base)
    for k, v in override.items():
        if k == "env_vars":
            out["env_vars"] = {**base.get("env_vars", {}), **v}
        else:
            out[k] = v
    return out


def to_key(runtime_env: Optional[dict]):
    """Hashable form for lease-pool shape keys."""
    if not runtime_env:
        return None
    return tuple(
        (k, tuple(v.items()) if isinstance(v, dict)
         else tuple(v) if isinstance(v, list) else v)
        for k, v in sorted(runtime_env.items()))


def from_key(key) -> Optional[dict]:
    if key is None:
        return None
    out = {}
    for k, v in key:
        if k == "env_vars":
            out[k] = dict(v)
        elif k in ("py_modules", "pip", "uv"):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def env_hash(runtime_env: Optional[dict]) -> str:
    """Stable worker-pool key ('' = plain base environment)."""
    if not runtime_env:
        return ""
    blob = json.dumps(runtime_env, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


# --- working_dir / py_modules packaging -------------------------------
# On a real multi-host cluster, worker nodes don't share the driver's
# filesystem: local paths are packed into content-addressed zips in the
# control KV at submit time ("pkg://<hash>/<name>") and extracted into
# a per-node cache by the agent before worker spawn (reference:
# _private/runtime_env/working_dir.py + packaging.py, which upload to
# the GCS package store the same way).

PKG_PREFIX = "pkg://"
PKG_KV_PREFIX = "__rtpkg:"
PKG_MAX_BYTES = 64 * 1024 * 1024        # control kv value cap

_PACK_CACHE: dict = {}    # abs path -> (signature, "pkg://..." uri)


def _dir_signature(path: str) -> tuple:
    sig = []
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for fn in sorted(files):
            p = os.path.join(root, fn)
            try:
                st = os.stat(p)
                sig.append((os.path.relpath(p, path), st.st_mtime_ns,
                            st.st_size))
            except OSError:
                pass
    return tuple(sig)


def _pack_path(path: str) -> bytes:
    """Deterministic zip of a file or directory tree."""
    import io
    import zipfile
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        if os.path.isdir(path):
            for root, dirs, files in sorted(os.walk(path)):
                dirs.sort()
                for fn in sorted(files):
                    p = os.path.join(root, fn)
                    z.write(p, os.path.relpath(p, path))
        else:
            z.write(path, os.path.basename(path))
    return buf.getvalue()


def publish_packages(runtime_env: Optional[dict], kv_put,
                     kv_has=None) -> Optional[dict]:
    """Driver-side: replace local working_dir/py_modules paths with
    content-addressed pkg:// uris, uploading each zip to the control
    KV once (overwrite=False — content-addressed, so a repeat upload
    is a no-op). ``kv_put(key, value)`` is the ctx's kv call;
    ``kv_has(key) -> bool`` (optional) lets a local cache hit cheaply
    verify the blob wasn't LRU-evicted from the head before skipping
    the upload. Paths already in pkg:// form pass through (job-level
    inheritance)."""
    if not runtime_env:
        return runtime_env

    def to_uri(path: str) -> str:
        if path.startswith(PKG_PREFIX):
            return path
        is_dir = os.path.isdir(path)
        sig = (_dir_signature(path) if is_dir
               else ("f", os.stat(path).st_mtime_ns))
        hit = _PACK_CACHE.get(path)
        if hit is not None and hit[0] == sig:
            uri = hit[1]
            if kv_has is None or kv_has(PKG_KV_PREFIX + pkg_digest(uri)):
                return uri
            # head evicted the blob since we last published: re-upload
        data = _pack_path(path)
        if len(data) > PKG_MAX_BYTES:
            raise ValueError(
                f"runtime_env package {path!r} is "
                f"{len(data)} B zipped (> {PKG_MAX_BYTES}); ship big "
                f"assets via the object store or bake them into the "
                f"image")
        digest = hashlib.sha1(data).hexdigest()[:20]
        kv_put(PKG_KV_PREFIX + digest, data)
        # the uri records whether the source was a file or a directory
        # — extraction shape alone cannot distinguish a dir holding one
        # same-named file from a packed file
        kind = "d" if is_dir else "f"
        uri = (f"{PKG_PREFIX}{digest}/{kind}/"
               f"{os.path.basename(path.rstrip('/'))}")
        _PACK_CACHE[path] = (sig, uri)
        return uri

    out = dict(runtime_env)
    if out.get("working_dir"):
        out["working_dir"] = to_uri(out["working_dir"])
    if out.get("py_modules"):
        out["py_modules"] = sorted(to_uri(m) for m in out["py_modules"])
    return out


def _pkg_cache_root() -> str:
    return os.environ.get(
        "RAY_TPU_PKG_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "ray_tpu_torch",
                     "pkgs"))


def pkg_digest(uri: str) -> str:
    assert uri.startswith(PKG_PREFIX), uri
    return uri[len(PKG_PREFIX):].partition("/")[0]


def pkg_is_cached(uri: str) -> bool:
    """True when this node already extracted the package (agents skip
    the KV download entirely then)."""
    return os.path.exists(os.path.join(_pkg_cache_root(),
                                       pkg_digest(uri), ".ready"))


def materialize_package(uri: str, kv_get) -> str:
    """Agent-side: pkg://<hash>/<d|f>/<name> -> local extracted path
    (per-hash cache, lock-guarded extract-then-rename so a crashed
    extraction never leaves a half directory)."""
    import fcntl
    import io
    import shutil
    import zipfile
    rest = uri[len(PKG_PREFIX):]
    digest, _, tail = rest.partition("/")
    kind, _, name = tail.partition("/")
    root = _pkg_cache_root()
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, digest)
    marker = os.path.join(final, ".ready")
    if not os.path.exists(marker):
        with open(os.path.join(root, f".{digest}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(marker):
                data = kv_get(PKG_KV_PREFIX + digest)
                if not data:
                    raise FileNotFoundError(
                        f"runtime_env package {digest} not in the "
                        f"cluster KV (evicted or head restarted "
                        f"without persistence?)")
                tmp = f"{final}.tmp{os.getpid()}"
                shutil.rmtree(tmp, ignore_errors=True)
                with zipfile.ZipFile(io.BytesIO(bytes(data))) as z:
                    z.extractall(tmp)
                open(os.path.join(tmp, ".ready"), "w").close()
                os.replace(tmp, final)
    # a packed FILE resolves to its single member; a DIRECTORY to the
    # extraction root (the uri's kind segment decides — extraction
    # shape alone is ambiguous)
    if kind == "f":
        return os.path.join(final, name)
    return final


def resolve_packages(runtime_env: Optional[dict], kv_get) -> Optional[dict]:
    """Agent-side: swap pkg:// uris for local extracted paths before
    the env is applied to a worker."""
    if not runtime_env:
        return runtime_env
    out = dict(runtime_env)
    wd = out.get("working_dir")
    if wd and wd.startswith(PKG_PREFIX):
        out["working_dir"] = materialize_package(wd, kv_get)
        out["_wd_from_pkg"] = True    # workers cwd into a private copy
    mods = out.get("py_modules")
    if mods and any(m.startswith(PKG_PREFIX) for m in mods):
        out["py_modules"] = [
            materialize_package(m, kv_get)
            if m.startswith(PKG_PREFIX) else m for m in mods]
    return out


# --- pip/uv cached venvs ----------------------------------------------

def _venv_cache_dir() -> str:
    return os.environ.get(
        "RAY_TPU_VENV_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "ray_tpu_torch",
                     "venvs"))


def venv_key(packages: List[str]) -> str:
    import sys
    blob = json.dumps([sys.version_info[:2], sorted(packages)],
                      default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


# requirement-set key -> (monotonic ts, error). A failed install is not
# retried for _FAIL_TTL_S: without this, every task with the same broken
# requirements pays the full multi-minute install-and-fail again.
_FAILED_VENVS: dict = {}
_FAIL_TTL_S = 60.0


def ensure_venv(packages: List[str], prefer_uv: bool = False) -> str:
    """Create-or-reuse a venv holding `packages`; returns its python.
    Cached per requirement set + interpreter minor version; concurrent
    creators serialize on a file lock and the build lands via atomic
    rename, so a crashed installer never leaves a half-venv behind
    (reference: _private/runtime_env/{pip.py,uv.py} cached per-URI
    environments)."""
    import fcntl
    import shutil
    import subprocess
    import sys
    import time as _time
    root = _venv_cache_dir()
    os.makedirs(root, exist_ok=True)
    key = venv_key(packages)
    final = os.path.join(root, key)
    py = os.path.join(final, "bin", "python")
    if os.path.exists(py):
        return py
    failed = _FAILED_VENVS.get(key)
    if failed is not None:
        ts, err = failed
        if _time.monotonic() - ts < _FAIL_TTL_S:
            raise RuntimeError(
                f"runtime_env install recently failed (cached "
                f"{_FAIL_TTL_S:.0f}s): {err}")
        del _FAILED_VENVS[key]
    lock_path = os.path.join(root, f".{key}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(py):      # built while we waited on the lock
            return py
        tmp = f"{final}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            # --system-site-packages: the delta installs on top of the
            # image's torch/ray_tpu_torch instead of re-resolving the world
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 tmp], check=True, capture_output=True)
            tmp_py = os.path.join(tmp, "bin", "python")
            uv = shutil.which("uv") if prefer_uv else None
            if uv:
                cmd = [uv, "pip", "install", "--python", tmp_py,
                       *packages]
            else:
                cmd = [tmp_py, "-m", "pip", "install",
                       "--disable-pip-version-check", *packages]
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            if r.returncode != 0:
                raise RuntimeError(
                    f"runtime_env package install failed "
                    f"({' '.join(packages)}): {r.stderr[-2000:]}")
            os.replace(tmp, final)
        except Exception as e:  # noqa: BLE001 — negative-cache + rethrow
            _FAILED_VENVS[key] = (_time.monotonic(), str(e)[:500])
            raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return py


def venv_python(runtime_env: Optional[dict]) -> Optional[str]:
    """The interpreter a worker for this env must run under, or None
    for the base interpreter. BLOCKS on first use of a requirement set
    (the agent calls it off-loop in an executor)."""
    if not runtime_env:
        return None
    if runtime_env.get("uv"):
        return ensure_venv(runtime_env["uv"], prefer_uv=True)
    if runtime_env.get("pip"):
        return ensure_venv(runtime_env["pip"], prefer_uv=False)
    return None


def apply_to_env(runtime_env: Optional[dict], env: dict) -> dict:
    """Fold a runtime env into a worker's process environment."""
    if not runtime_env:
        return env
    env = dict(env)
    env.update(runtime_env.get("env_vars", {}))
    paths = list(runtime_env.get("py_modules", []))
    wd = runtime_env.get("working_dir")
    if wd:
        paths.append(wd)
        env["RAY_TPU_RT_WORKING_DIR"] = wd
        if runtime_env.get("_wd_from_pkg"):
            # shared immutable cache entry: the worker must cwd into a
            # private copy (see worker._amain)
            env["RAY_TPU_RT_WD_COPY"] = "1"
    if paths:
        prev = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(
            paths + ([prev] if prev else []))
    return env
