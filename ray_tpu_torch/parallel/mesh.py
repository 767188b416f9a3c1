"""The single-device train step: ``TrainState``, ``default_optimizer``,
``make_train_step`` and ``make_eval_step``.

Counterpart of ``ray_tpu/parallel/mesh.py`` on one device: loss, its
gradients by autograd (attention's through the hand-written K1/K2/K3
kernels on the card), the global norm of the unclipped gradients, and
optax's ``chain(clip_by_global_norm, adamw(warmup_cosine_decay))``
written out. The step updates the model and the optimizer's moments in
place (JAX returns new arrays; here that would double the memory of
every parameter). Meshes (data, fsdp, tensor, context axes) are not
ported yet: passing one raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional

import torch
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama


@dataclasses.dataclass
class TrainState:
    """The model (its parameters, updated in place), the optimizer state
    and the number of steps taken."""
    params: nn.Module
    opt_state: Any
    step: int


# AdamW's constants in the JAX package's default_optimizer
B1, B2, EPS = 0.9, 0.95, 1e-8


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor, f32 0-d."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamWState:
    mu: List[torch.Tensor]      # first moments, in each parameter's dtype
    nu: List[torch.Tensor]      # second moments, likewise
    count: int = 0              # updates applied


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(schedule,
    b1=B1, b2=B2, eps=EPS, eps_root=0, weight_decay))`` with the
    warmup-cosine schedule, step for step:

    - clip: when the gradients' global norm ``g`` is ``>= grad_clip``,
      each becomes ``g_i / g * grad_clip`` (no epsilon, unlike
      ``torch.nn.utils.clip_grad_norm_``);
    - the moments live in each parameter's dtype (optax's
      ``mu_dtype=None``), bias-corrected by ``1 - b^count``;
    - decay applies to every parameter, embeddings and norms included;
    - the update at count ``c`` (from 0) is scaled by the schedule at
      ``c``: the first update has lr = 0 when there is a warmup.
    """
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, learning_rate, warmup,
        max(total, warmup + 1))`` at ``count``: linear from 0 over the
        warmup, then cosine down to 0 at the end (counted from 0, warmup
        included)."""
        peak, warmup = self.learning_rate, self.warmup_steps
        if count < warmup:
            return (0.0 - peak) * (1.0 - count / warmup) + peak
        span = max(self.total_steps, warmup + 1) - warmup
        t = min(count - warmup, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState([torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, state: AdamWState, params: List[torch.Tensor],
               grads: List[torch.Tensor], grad_norm: torch.Tensor) -> None:
        """One step in place: ``grads`` (scaled in place by the clip),
        the moments and ``params``. ``grad_norm`` is ``global_norm(grads)``
        of the unclipped gradients."""
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - B1 ** state.count
        bc2 = 1.0 - B2 ** state.count
        clip = torch.where(grad_norm < self.grad_clip,
                           torch.ones_like(grad_norm),
                           self.grad_clip / grad_norm)
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g.mul_(clip.to(g.dtype))
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            upd = (mu / bc1) / ((nu / bc2).sqrt() + EPS)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10_000,
                      grad_clip: float = 1.0) -> AdamW:
    """The JAX package's default: global-norm clipping, then AdamW (b1
    0.9, b2 0.95, eps 1e-8) on a linear-warmup cosine schedule from 0 to
    ``learning_rate`` and back to 0 at ``max(total_steps, warmup+1)``."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 grad_clip=grad_clip)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "device meshes (data/fsdp/tensor/context axes) are not ported "
            "yet (ROADMAP.md, Queue 1, training parallelism); pass "
            "mesh=None for the single-device step")


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg, mesh=None, *,
                    device: Optional[torch.device] = None,
                    optimizer: Optional[AdamW] = None,
                    loss_fn: Optional[Callable] = None,
                    model=llama):
    """Returns ``(init_fn, step_fn)``:

    - ``init_fn(generator=None, params=None) -> TrainState``: a trainable
      model from ``model.init_params(generator, cfg, device)``, or the
      given ``params`` module (e.g. from ``bridge.params_from_numpy(...,
      trainable=True)``), with fresh optimizer state. ``device=None`` is
      the CUDA device, and raises when there is none.
    - ``step_fn(state, batch) -> (state, metrics)``: loss and gradients
      of ``loss_fn(model, batch)`` (default ``model.loss_fn`` with
      ``cfg``), then one optimizer update, all in place; ``metrics`` has
      ``loss`` and ``grad_norm`` (the unclipped gradients' global norm),
      both f32 0-d tensors on the device, and ``step``.

    ``model`` is a module exposing ``init_params`` and ``loss_fn``, as
    ``ray_tpu_torch.models.llama`` does."""
    _no_mesh(mesh)
    opt = optimizer if optimizer is not None else default_optimizer()
    _loss = loss_fn if loss_fn is not None else (
        lambda m, b: model.loss_fn(m, b, cfg))

    def init_fn(generator: Optional[torch.Generator] = None,
                params: Optional[nn.Module] = None) -> TrainState:
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                raise ValueError("init_fn needs a generator or params")
            params = model.init_params(generator, cfg, dev, trainable=True)
        elif any(p.device != dev or not p.requires_grad
                 for p in params.parameters()):
            raise ValueError(f"params must be trainable and on {dev}")
        return TrainState(params, opt.init(list(params.parameters())), 0)

    def step_fn(state: TrainState, batch: dict):
        net = state.params
        params = list(net.parameters())
        for p in params:
            p.grad = None
        loss = _loss(net, _to_device(batch, params[0].device))
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        gnorm = global_norm(grads)
        opt.update(state.opt_state, params, grads, gnorm)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return init_fn, step_fn


def make_eval_step(cfg, mesh=None, *, model=llama):
    """``eval_fn(params, batch) -> loss`` without gradients."""
    _no_mesh(mesh)

    @torch.no_grad()
    def eval_fn(params: nn.Module, batch: dict) -> torch.Tensor:
        dev = next(params.parameters()).device
        return model.loss_fn(params, _to_device(batch, dev), cfg)

    return eval_fn
