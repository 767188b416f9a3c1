"""Every public name of every package ``__init__`` of the JAX package
resolves on the port's counterpart package, to the same kind of object.

A package's public names are its ``__all__``, or else the names its
top-level statements bind that do not start with ``_`` (imports of the
standard library left out), plus the names its module ``__getattr__``
serves lazily (the string constants, or the module-level tuples of
them, that it compares ``name`` with). Each resolves on the port by
``getattr`` on ``ray_tpu_torch.<same path>``: a module where the JAX
package's is a module, a callable where it is callable. ``JAX_ONLY``
states the names that belong to JAX, with the port's counterpart where
there is one, which is checked in their place.
"""

import ast
import importlib
import json
import pathlib
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
INITS = sorted((ROOT / "ray_tpu").rglob("__init__.py"))

# JAX's shard_map shim and jax.distributed's set-up have no meaning in
# the port; JaxTrainer's counterpart is TorchTrainer and
# ensure_jax_distributed's is ensure_torch_distributed (torch.distributed).
JAX_ONLY = {"shard_map": None,
            "ensure_jax_distributed": "ensure_torch_distributed",
            "JaxTrainer": "TorchTrainer"}


# ops/attention.py, ops/flash_attention.py and ops/ring_attention.py are
# modules of the port under the names of the JAX package's functions;
# each is callable as its op (ops/__init__.py), so a module there stands
# for a callable: test_callable_op_modules_call_their_ops holds the calls.
CALLABLE_MODULES = {"attention", "flash_attention", "ring_attention"}


def _package(init: pathlib.Path) -> str:
    return ".".join(init.parent.relative_to(ROOT).parts)


def public_names(init: pathlib.Path) -> list:
    tree = ast.parse(init.read_text())
    consts, names = {}, []
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
            try:
                consts[target] = ast.literal_eval(node.value)
            except ValueError:
                consts[target] = None
            if target == "__all__":
                return list(consts[target])
            names.append(target)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.ImportFrom) and \
                (node.module or "").split(".")[0] == "ray_tpu":
            names += [a.asname or a.name for a in node.names]
    lazy = next((n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "__getattr__"), None)
    if lazy is not None:
        for cmp in ast.walk(lazy):
            if not isinstance(cmp, ast.Compare):
                continue
            for c in cmp.comparators:
                if isinstance(c, ast.Name):
                    names += list(consts.get(c.id) or ())
                elif isinstance(c, (ast.Tuple, ast.Constant)):
                    v = ast.literal_eval(c)
                    names += [v] if isinstance(v, str) else list(v)
    return sorted({n for n in names if not n.startswith("_")})


def test_every_jax_init_is_walked():
    """The walk sees every package of the JAX package, and the names of
    the lazy ones (util's submodules, the top level's API)."""
    pkgs = {_package(p) for p in INITS}
    assert {"ray_tpu", "ray_tpu.llm", "ray_tpu.ops", "ray_tpu.models",
            "ray_tpu.util", "ray_tpu.providers", "ray_tpu.train"} <= pkgs
    top = public_names(ROOT / "ray_tpu" / "__init__.py")
    assert {"init", "remote", "ActorDiedError", "llm", "rllib"} <= set(top)
    util = public_names(ROOT / "ray_tpu" / "util" / "__init__.py")
    assert {"ActorPool", "tpu", "joblib_backend"} <= set(util)


def _kind(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return "module"
    return "callable" if callable(obj) else "value"


# Run in a fresh process for each package, so that a name resolves only
# through the package itself, not through a submodule that an earlier
# import happened to load.
PROBE = """
import importlib, json, sys, types
try:
    port = importlib.import_module(sys.argv[1])
except ImportError:
    port = None
out = {}
for name in json.loads(sys.argv[2]):
    try:
        obj = getattr(port, name)
    except AttributeError:
        out[name] = "missing"
        continue
    out[name] = ("module" if isinstance(obj, types.ModuleType) else
                 "callable" if callable(obj) else "value")
print(json.dumps(out))
"""


def _port_package(pkg: str) -> str:
    # the Pallas kernels' package: their counterparts live in ops
    if pkg == "ray_tpu.ops.pallas":
        return "ray_tpu_torch.ops"
    return pkg.replace("ray_tpu", "ray_tpu_torch", 1)


@pytest.fixture(scope="module")
def resolved():
    """{package: (want, got)}: the JAX names' kinds, each under the
    port's name for it, and what the port's package resolves them to."""
    want = {}
    for init in INITS:
        pkg = _package(init)
        mod = importlib.import_module(pkg)
        want[pkg] = {JAX_ONLY.get(n) or n: _kind(getattr(mod, n))
                     for n in public_names(init)
                     if not (n in JAX_ONLY and JAX_ONLY[n] is None)}

    def probe(pkg):
        out = subprocess.run(
            [sys.executable, "-c", PROBE, _port_package(pkg),
             json.dumps(sorted(want[pkg]))], cwd=ROOT,
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return pkg, json.loads(out.stdout.splitlines()[-1])

    with ThreadPoolExecutor(4) as pool:
        got = dict(pool.map(probe, want))
    return {pkg: (want[pkg], got[pkg]) for pkg in want}


@pytest.mark.parametrize("init", INITS, ids=_package)
def test_jax_package_names_resolve_on_the_port(init, resolved):
    want, got = resolved[_package(init)]
    bad = {name: (kind, got[name]) for name, kind in want.items()
           if got[name] != kind and not (kind == "callable"
                                         and got[name] == "module"
                                         and name in CALLABLE_MODULES)}
    assert not bad, (_port_package(_package(init)), bad)


def test_callable_op_modules_call_their_ops():
    """``ops.attention``, ``ops.flash_attention`` and
    ``ops.ring_attention`` called as the JAX package's functions are
    called give their ops' results, bitwise, and stay the modules the
    port's code imports."""
    import torch

    from ray_tpu_torch import ops
    from ray_tpu_torch.ops import attention as attn_mod
    from ray_tpu_torch.ops import flash_attention as fa_mod
    from ray_tpu_torch.ops import ring_attention as ring_mod
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 64, generator=gen)
    k, v = (torch.randn(1, 16, 2, 64, generator=gen) for _ in range(2))
    assert ops.attention is attn_mod and ops.flash_attention is fa_mod
    assert callable(fa_mod.flash_attention_fwd)
    assert torch.equal(ops.attention(q, k, v, impl="reference"),
                       attn_mod.attention(q, k, v, impl="reference"))
    assert torch.equal(ops.flash_attention(q, k, v),
                       attn_mod.flash_attention(q, k, v))
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(fsdp=1, context=2), devices=("cpu",) * 2)
    parts = [list(t.split(8, dim=1)) for t in (q, k, v)]
    assert torch.equal(torch.cat(ops.ring_attention(*parts, mesh), 1),
                       torch.cat(ring_mod.ring_attention(*parts, mesh), 1))
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ops.mha_reference(q, k, v),
                               rtol=1e-5, atol=1e-5)
