"""Plain AdamW with global-norm clipping and a warmup-cosine schedule,
as the training traffic states it (optax's ``chain(clip_by_global_norm,
adamw)`` over ``warmup_cosine_decay_schedule``), in float32 arithmetic on
state held in the configuration's dtype: the parameters, their gradients
and both moments are stored as the configuration states them (bf16 for
a bf16 model, optax's ``mu_dtype=None``), and every sum, product, root
and norm between two stores is float32."""

from __future__ import annotations

import math
from typing import Dict

import torch

WHOLE = ("embed", "final_norm", "lm_head")     # kinds not stacked over layers


def schedule(opt: dict, count: int) -> float:
    """The learning rate of the update at ``count`` (from 0): linear from
    0 over ``warmup_steps``, then a cosine from the peak down to 0 at
    max(total_steps, warmup_steps + 1)."""
    peak, warm = float(opt["learning_rate"]), int(opt["warmup_steps"])
    if count < warm:
        return peak * count / warm
    span = max(int(opt["total_steps"]), warm + 1) - warm
    t = min(count - warm, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))


@torch.no_grad()
def step(W: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
         nu: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         grad_norm: float, count: int, opt: dict) -> float:
    """One update in place of ``W``, ``mu`` and ``nu`` from ``grads``
    (unclipped, stacked like W), the ``count``-th (from 0). Returns the
    clip factor applied."""
    b1, b2 = (float(x) for x in opt["betas"])
    eps, wd = float(opt["eps"]), float(opt["weight_decay"])
    lr = schedule(opt, count)
    c = count + 1
    bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
    clip = 1.0 if grad_norm < opt["grad_clip"] else \
        float(opt["grad_clip"]) / grad_norm
    for k, p_all in W.items():
        # a kind stacked over the layers is updated one layer at a time
        rows = [None] if k in WHOLE else range(p_all.shape[0])
        for i in rows:
            sl = slice(None) if i is None else i
            p = p_all[sl].float()
            g = grads[k][sl].float() * clip
            m = mu[k][sl].float() * b1 + (1.0 - b1) * g
            v = nu[k][sl].float() * b2 + (1.0 - b2) * g * g
            upd = (m / bc1) / ((v / bc2).sqrt() + eps) + wd * p
            p_all[sl] = (p - lr * upd).to(p_all.dtype)
            mu[k][sl] = m.to(mu[k].dtype)
            nu[k][sl] = v.to(nu[k].dtype)
    return clip
