"""Model families of the port: the Llama decoder and the MoE family."""

from ray_tpu_torch.models import llama
from ray_tpu_torch.models import moe

__all__ = ["llama", "moe"]
