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

K1 with lse is the custom op ``ray_tpu_torch::flash_fwd_lse``
(``flash_fwd_lse``): one op at the dispatcher, returning ``(o, lse)``.
That is what selective checkpointing sees, so a remat policy can save
the pair (the JAX package's ``attn_out``/``attn_lse`` names,
``ray_tpu/ops/attention.py:90-92``) and its recompute then hands back
the saved pair without entering the op. Its body counts ``calls`` (CPU
and CUDA alike) and, through ``flash_attention_fwd``, K1's launches, so
a saved result counts neither.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.flash_attention import (_repeat_kv,  # noqa: F401
                                               flash_attention_bwd,
                                               flash_attention_fwd,
                                               mha_reference)


def _flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, sm_scale: Optional[float]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with the lse output -> (o, lse): the kernel on CUDA tensors
    (or this raises), the plain version on CPU tensors."""
    flash_fwd_lse.calls += 1
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               with_lse=True)


flash_fwd_lse = torch.library.custom_op(
    "ray_tpu_torch::flash_fwd_lse", _flash_fwd_lse, mutates_args=())


@flash_fwd_lse.register_fake
def _(q, k, v, causal, sm_scale):
    """Shapes only, for tracing and the meta device (PyTorch answers a
    meta tensor with an op's fake implementation)."""
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


flash_fwd_lse.calls = 0    # op bodies run: forwards not served from a save


class _Flash(torch.autograd.Function):
    """Flash attention with a hand-written backward: the forward saves
    (q, k, v, o, lse), o and lse exactly as ``flash_fwd_lse`` returned
    them (under selective checkpointing, the saved pair), and the
    backward rebuilds p from lse per tile."""

    bwd_calls = 0          # backwards run (K2 and K3 once each)

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float]):
        o, lse = flash_fwd_lse(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        _Flash.bwd_calls += 1
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
