"""Prefill/decode disaggregation: the prompt forward on one engine, decode
on another.

Counterpart of ``ray_tpu/llm/pd.py``. ``PrefillEngine.prefill`` runs a
prompt's forward pass and returns a host-staged payload that a decode
``LLMEngine`` admits with ``generate(..., prefilled=payload)``: the
decode side writes the shipped KV into its cache and samples the first
token from the shipped logits, with no forward pass of its own.

The payload's KV is sliced to block granularity (the paged cache's token
block, with the same gcd rule the engine applies), so the transfer scales
with the prompt: a 65-token prompt ships 80 positions at block 16, not a
128-position bucket. It ships in the cache dtype, as the JAX package's
does, so both send the same bytes. numpy has no bfloat16 of its own (the
JAX package's comes from ml_dtypes, which the port does not need), so a
bf16 payload carries the raw bits as ``uint16`` arrays, bit for bit the
JAX payload's ``.view(np.uint16)``; the payload's ``"kv_dtype"`` names
the dtype the arrays hold, and ``kv_to_torch`` reads them back.

The ``uint16`` format is the port's own: the port's engine admits it and
the JAX package's payloads, but the JAX package's decode engine cannot
read it (it would take the bits as integers).

``prefill(..., device=True)`` keeps the KV on the engine's device
instead and returns ``TensorRef`` handles (runtime/device_store.py): a
decode engine in the same process admits the parked tensors with no
host copy; one in another process pays one fetch (the store ships bf16
as the same ``uint16`` bits) and frees the handles once its cache holds
the KV.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.config import get_config
from ray_tpu_torch.llm import model as lm
from ray_tpu_torch.models.llama import Llama, LlamaConfig
from ray_tpu_torch.runtime.device_store import put_device


def kv_to_numpy(x: torch.Tensor) -> np.ndarray:
    """A KV tensor as the payload ships it: its own dtype on the host,
    bf16 as its raw bits in ``uint16``."""
    x = x.cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def kv_dtype_of(x: np.ndarray, kv_dtype: Optional[str] = None) -> str:
    """The dtype a shipped KV array holds, by its numpy dtype and the
    payload's ``"kv_dtype"`` tag: ``uint16`` bits tagged ``"bfloat16"``
    (the port's bf16), the JAX package's ml_dtypes bfloat16 (by its
    ``dtype.name``, without importing ml_dtypes), or a float dtype. A tag,
    where there is one, must name what the array holds. Raises
    ``ValueError`` for anything else, such as integer bits that lost
    their tag."""
    name = x.dtype.name
    if kv_dtype == "bfloat16" and name == "uint16":
        return kv_dtype
    if (x.dtype.kind == "f" or name == "bfloat16") \
            and kv_dtype in (None, name):
        return name
    raise ValueError(
        f"prefilled KV of dtype {name} with kv_dtype {kv_dtype!r}: ship "
        "float arrays, or bf16 as uint16 bits tagged 'bfloat16'")


def kv_to_torch(x: np.ndarray, kv_dtype: Optional[str] = None
                ) -> torch.Tensor:
    """A shipped KV array as a CPU tensor of the dtype it holds
    (``kv_dtype_of``; a copy, never a view of the payload)."""
    if kv_dtype_of(x, kv_dtype) == "bfloat16":
        return torch.tensor(x.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(x)


class PrefillEngine:
    """Stateless prompt prefill: tokens -> {"k", "v", "logits",
    "length"}. Shape-bucketed like ``LLMEngine``'s own prefill (the same
    ``lm.prefill`` at the same bucket, so a decode engine that admits the
    payload continues exactly where a unified engine would); prompts past
    the largest bucket stream through ``lm.prefill_chunk``."""

    def __init__(self, cfg: LlamaConfig, params: Llama, *,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512),
                 max_len: int = 1024,
                 cache_dtype="bfloat16",
                 block_size: Optional[int] = None,
                 device=None):
        """``params`` is the port's ``Llama`` module on ``device``
        (``None``: the CUDA device, raising without one). ``block_size``
        0 ships whole buckets; ``None`` reads the Config's
        ``kvcache_block_size``, as the decode engine does."""
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}: move them first")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len)) or (max_len,)
        self.cache_dtype = getattr(torch, cache_dtype) \
            if isinstance(cache_dtype, str) else cache_dtype
        if block_size is None:
            block_size = int(get_config().kvcache_block_size)
        # the engine's gcd rule, so both sides agree on what a block is
        if block_size > 0:
            for v in (*self.buckets, max_len):
                block_size = math.gcd(block_size, v)
        self.block_size = max(0, block_size)

    def _ship_len(self, n: int, upper: int) -> int:
        """Positions to ship for an n-token prompt: the smallest block
        multiple covering it (bucket-granular when blocks are off)."""
        if self.block_size <= 0:
            return upper
        b = self.block_size
        return min(upper, -(-n // b) * b)

    @torch.no_grad()
    def prefill(self, tokens: Sequence[int], *, device: bool = False
                ) -> dict:
        """Run the prompt's forward pass. Returns {"k", "v": numpy
        (layers, ship, kvh, hd) in the cache dtype (bf16 as ``uint16``
        bits), "kv_dtype": the cache dtype's name, "logits": numpy
        float32 (vocab,), "length": n}, ``ship`` the block multiple
        covering the prompt. ``device=True`` parks k/v in the cache
        dtype on the engine's device and returns their ``TensorRef``
        handles in place of the arrays (runtime/device_store.py)."""
        tokens = list(map(int, tokens))
        n = len(tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.max_len:
            raise ValueError(
                f"prompt of {n} tokens exceeds max_len {self.max_len}")
        cfg = self.cfg
        big = self.buckets[-1]
        if n <= big:
            b = lm.bucket_for(self.buckets, n)
            padded = torch.tensor(lm.pad_prompt(tokens, b),
                                  device=self.device)
            logits, kv = lm.prefill(self.params, padded, n, cfg, b)
            ship = self._ship_len(n, b)
        else:
            # accumulate into the smallest bucket multiple holding the
            # prompt: a padded last piece never overruns it
            acc = lm.zero_acc(cfg, -(-n // big) * big, self.cache_dtype,
                              self.device)
            logits, kv = lm.chunked_prefill(self.params, tokens,
                                            self.buckets, acc, cfg)
            ship = self._ship_len(n, self.max_len)
        if device:
            # contiguous: the handle pins the shipped blocks, not the
            # whole bucket the forward computed
            out = {key: put_device(
                kv[key][:, :ship].to(self.cache_dtype).contiguous())
                for key in ("k", "v")}
        else:
            out = {key: kv_to_numpy(kv[key][:, :ship].to(self.cache_dtype))
                   for key in ("k", "v")}
        out.update(kv_dtype=str(self.cache_dtype).removeprefix("torch."),
                   logits=logits.float().cpu().numpy(), length=n)
        return out
