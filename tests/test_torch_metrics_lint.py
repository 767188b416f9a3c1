"""The metric naming lint (``scripts/check_metrics_lint.py``) over the
port: every metric the port registers is snake_case, unit-suffixed and
described, every ``events.record`` category is registered, and every
collective/chaos/trace knob of the port's Config is exercised by a test,
as the JAX package's are.

``tests/test_metrics_lint.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename). Its
``_load_linter`` is replaced by one that loads the linter the same way,
with every ``ray_tpu`` name rewritten, so the lint instantiates the
port's metrics and scans the port's source tree; the script itself is
unchanged.
"""

import pathlib
import re
import types

from _torch_ported import adopt, ported

LINTER = pathlib.Path(__file__).resolve().parent.parent / "scripts" / \
    "check_metrics_lint.py"


def _load_port_linter() -> types.ModuleType:
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", LINTER.read_text())
    mod = types.ModuleType("check_metrics_lint_torch")
    mod.__file__ = str(LINTER)
    exec(compile(src, str(LINTER), "exec"), mod.__dict__)
    return mod


_mod = ported("test_metrics_lint")
_mod._load_linter = _load_port_linter
adopt(_mod, globals())
