"""Attention ops: the plain reference and the flash kernel dispatch.

Counterpart of ``ray_tpu/ops/attention.py``, inference only. Public
layout is (batch, seq, heads, head_dim); GQA is supported by num_kv_heads
dividing num_heads. ``impl="auto"`` means the CUDA kernel for CUDA
tensors and the plain version for CPU tensors, at every sequence length
(the TPU's ``seq >= 128`` threshold existed for its 128-lane tiling and
does not apply on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (_repeat_kv,  # noqa: F401
                                               flash_attention_fwd,
                                               mha_reference)


@torch.no_grad()
def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward, (b, s, h, d) layout: the hand-written
    kernel on CUDA tensors, its plain version on CPU tensors."""
    return flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sm_scale=sm_scale, q_offset=q_offset)


def attention(q, k, v, *, causal: bool = True,
              sm_scale: Optional[float] = None, impl: str = "auto",
              q_offset: Optional[int] = None) -> torch.Tensor:
    """Dispatch: 'auto' and 'flash' take the kernel path (the kernel on
    CUDA, its plain version on CPU); 'reference' forces the plain
    attention on any device."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset)
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    raise ValueError(f"unknown attention impl: {impl!r} "
                     "(auto | flash | reference)")
