"""Serving stack of the port: cache-aware Llama forwards, the paged KV
pool and the continuous-batching ``LLMEngine``.

Submodules are imported explicitly (``ray_tpu_torch.llm.engine``)."""
