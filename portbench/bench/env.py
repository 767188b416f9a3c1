"""Fixed cache directories inside the checkout, set before torch is
imported, so that only a checkout's first run builds or compiles and two
checkouts share nothing. The port's kernels build into
``ray_tpu_torch/_build/`` inside the checkout already."""

from __future__ import annotations

import os
import sys
from pathlib import Path


def caches(root: Path) -> dict:
    base = Path(root) / "portbench" / ".cache"
    return {"pycache": base / "pycache", "TRITON_CACHE_DIR": base / "triton",
            "CUDA_CACHE_PATH": base / "nv",
            "TORCH_EXTENSIONS_DIR": base / "torch_extensions",
            "TORCHINDUCTOR_CACHE_DIR": base / "inductor"}


def setup(root: Path) -> None:
    """Bytecode written under the checkout (the chip host sets
    PYTHONDONTWRITEBYTECODE and ships its packages without bytecode),
    and every other cache directory in the checkout."""
    dirs = caches(root)
    for name, path in dirs.items():
        path.mkdir(parents=True, exist_ok=True)
        if name != "pycache":
            os.environ[name] = str(path)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(dirs["pycache"])
