"""Run a JAX-package test module on the port, unedited.

``ported(name)`` loads ``tests/<name>.py`` with every ``ray_tpu`` name
rewritten to ``ray_tpu_torch``, as a module of its own, and
``adopt(module, into)`` copies its tests and fixtures into the calling
test file, so each reference test runs against the port under the
calling file's id. The module is registered with cloudpickle by value:
the runtime's workers then rebuild its functions and classes from their
bytes instead of importing the module, which they could not (the
original imports the JAX package).
"""

import pathlib
import re
import sys
import types

import cloudpickle

HERE = pathlib.Path(__file__).resolve().parent


def ported(name: str) -> types.ModuleType:
    path = HERE / f"{name}.py"
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", path.read_text())
    mod = types.ModuleType(f"_torch_ported_{name}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    cloudpickle.register_pickle_by_value(mod)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def adopt(mod: types.ModuleType, into: dict) -> None:
    """Copy ``mod``'s tests and fixtures into the namespace ``into``, in
    their order of definition. Refuses a name the namespace already
    holds, so no test is silently shadowed."""
    for name, obj in vars(mod).items():
        is_fixture = hasattr(obj, "_fixture_function_marker") or \
            hasattr(obj, "_pytestfixturefunction")
        if name.startswith("test_") or is_fixture:
            if name in into:
                raise ValueError(f"{name} of {mod.__name__} is taken")
            into[name] = obj
