"""Attention ops of the port: hand-written CUDA kernels and their plain
PyTorch versions.

The JAX package's ``ray_tpu.ops`` exports the functions ``attention``,
``mha_reference``, ``flash_attention`` and ``ring_attention``. Here three
of those names are also the modules that hold the ops
(``ops/flash_attention.py`` holds K1-K3's wrappers), so each of the three
modules is callable as its op: ``ops.attention(q, k, v)`` is
``ops.attention.attention``, ``ops.flash_attention(q, k, v)`` the
differentiable ``ops.attention.flash_attention`` and
``ops.ring_attention(...)`` ``ops.ring_attention.ring_attention``, each
looked up at the call, so a patched op is the one called.
"""

import types

from ray_tpu_torch.ops import attention, flash_attention, ring_attention
from ray_tpu_torch.ops.flash_attention import mha_reference


class _OpModule(types.ModuleType):
    """A module that is also the op ``__op__`` names: (module, name)."""

    def __call__(self, *args, **kwargs):
        home, name = self.__op__
        return getattr(home, name)(*args, **kwargs)


for _mod, _op in ((attention, (attention, "attention")),
                  (flash_attention, (attention, "flash_attention")),
                  (ring_attention, (ring_attention, "ring_attention"))):
    _mod.__class__ = _OpModule
    _mod.__op__ = _op
del _mod, _op

__all__ = ["attention", "mha_reference", "flash_attention",
           "ring_attention"]
