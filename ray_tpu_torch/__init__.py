"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's serving path and
single-device training step.

The counterpart of ``ray_tpu``'s Llama decoder, paged KV pool,
``LLMEngine`` and ``make_train_step``, with hand-written Hopper kernels
in place of the Pallas TPU kernels on those paths. It imports torch and
numpy, never jax and never ``ray_tpu``. Submodules load lazily.
"""

_SUBMODULES = ("bridge", "models", "ops", "llm", "parallel")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(
        f"module 'ray_tpu_torch' has no attribute {name!r}")
