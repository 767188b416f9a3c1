"""Serving stack of the port: cache-aware Llama forwards, the paged KV
pool and the continuous-batching ``LLMEngine``, exported as the JAX
package's ``ray_tpu.llm`` exports them."""

from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.model import decode_step, init_cache, prefill

__all__ = ["LLMEngine", "prefill", "decode_step", "init_cache"]
