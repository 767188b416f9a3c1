"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's serving path.

The counterpart of ``ray_tpu``'s Llama decoder, paged KV pool and
``LLMEngine``, with hand-written Hopper kernels in place of the Pallas
TPU kernels on that path. It imports torch and numpy, never jax and
never ``ray_tpu``. Submodules load lazily.
"""

_SUBMODULES = ("bridge", "models", "ops", "llm")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(
        f"module 'ray_tpu_torch' has no attribute {name!r}")
