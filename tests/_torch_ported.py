"""Run a JAX-package test module on the port, unedited.

``ported(name)`` loads ``tests/<name>.py`` with every ``ray_tpu`` name
rewritten to ``ray_tpu_torch``, as a module of its own, and
``adopt(module, into)`` copies its tests and fixtures into the calling
test file, so each reference test runs against the port under the
calling file's id. ``ported(name, rename=)`` also renames whole words
of the JAX API to the port's (e.g. ``JaxTrainer`` to ``TorchTrainer``,
jax.distributed's env names to torchrun's); the adopting file prints its
map in its docstring, and the map never touches an assertion's logic.
``adopt(..., skip=)`` leaves out the tests of code the port does not
have yet, each with the reason naming its ROADMAP.md Queue 1 item. The
module is registered with cloudpickle by value:
the runtime's workers then rebuild its functions and classes from their
bytes instead of importing the module, which they could not (the
original imports the JAX package).
"""

import pathlib
import re
import sys
import types
from typing import Dict, Optional

import cloudpickle

HERE = pathlib.Path(__file__).resolve().parent


def ported(name: str, rename: Optional[Dict[str, str]] = None
           ) -> types.ModuleType:
    path = HERE / f"{name}.py"
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", path.read_text())
    for old, new in (rename or {}).items():
        src, n = re.subn(rf"\b{re.escape(old)}\b", new, src)
        if not n:
            raise ValueError(f"{old!r} does not occur in {name}.py")
    mod = types.ModuleType(f"_torch_ported_{name}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    cloudpickle.register_pickle_by_value(mod)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def adopt(mod: types.ModuleType, into: dict, *,
          skip: Optional[Dict[str, str]] = None) -> None:
    """Copy ``mod``'s tests and fixtures into the namespace ``into``, in
    their order of definition. ``skip`` maps the tests left out to why
    (the Queue 1 item they wait for); each must be a test of ``mod``.
    Refuses a name the namespace already holds, so no test is silently
    shadowed."""
    tests = {n for n in vars(mod) if n.startswith("test_")}
    skip = dict(skip or {})
    if set(skip) - tests:
        raise ValueError(f"not tests of {mod.__name__}: "
                         f"{sorted(set(skip) - tests)}")
    for name, obj in vars(mod).items():
        is_fixture = hasattr(obj, "_fixture_function_marker") or \
            hasattr(obj, "_pytestfixturefunction")
        if name in skip:
            continue
        if name.startswith("test_") or is_fixture:
            if name in into:
                raise ValueError(f"{name} of {mod.__name__} is taken")
            into[name] = obj
