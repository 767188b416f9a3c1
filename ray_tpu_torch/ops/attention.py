"""Attention ops: the plain reference and the flash kernel dispatch.

Counterpart of ``ray_tpu/ops/attention.py``. Public layout is (batch,
seq, heads, head_dim); GQA is supported by num_kv_heads dividing
num_heads. ``impl="auto"`` means the CUDA kernels for CUDA tensors and
their plain versions for CPU tensors, at every sequence length (the
TPU's ``seq >= 128`` threshold existed for its 128-lane tiling and does
not apply on the card).

``flash_attention`` is differentiable: with grad it goes through
``_Flash`` (the counterpart of ``jax.custom_vjp`` ``_flash``), whose
forward runs K1 with the lse output and whose backward runs K2 and K3.
On CPU tensors the same Function runs the plain versions, so the CPU
tests exercise the same autograd wiring.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (_repeat_kv,  # noqa: F401
                                               flash_attention_bwd,
                                               flash_attention_fwd,
                                               mha_reference)


class _Flash(torch.autograd.Function):
    """Flash attention with a hand-written backward: the forward saves
    (q, k, v, o, lse), the backward rebuilds p from lse per tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float]):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         sm_scale=ctx.sm_scale,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention, (b, s, h, d) layout: the hand-written kernels on
    CUDA tensors, their plain versions on CPU tensors. Differentiable
    except with ``q_offset`` (the inference-only chunked-prefill causal
    placement; the backward assumes the queries are the last rows)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if not grad:
        return flash_attention_fwd(q, k, v, causal=causal,
                                   sm_scale=sm_scale, q_offset=q_offset)
    if q_offset is not None:
        raise NotImplementedError(
            "q_offset (chunked-prefill causal placement) is an "
            "inference-only path; the backward kernels assume the "
            "queries are the last rows")
    return _Flash.apply(q, k, v, causal, sm_scale)


def attention(q, k, v, *, causal: bool = True,
              sm_scale: Optional[float] = None, impl: str = "auto",
              q_offset: Optional[int] = None) -> torch.Tensor:
    """Dispatch: 'auto' and 'flash' take the kernel path (the kernels on
    CUDA, their plain versions on CPU); 'reference' forces the plain
    attention, differentiated by autograd, on any device."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset)
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    raise ValueError(f"unknown attention impl: {impl!r} "
                     "(auto | flash | reference)")
