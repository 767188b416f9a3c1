"""Shared policy/value network building blocks.

One MLP trunk (He-init hidden layers, tanh activations) reused by every
algorithm head — the minimal analog of the reference's RLModule catalog
(reference: rllib/core/rl_module/ + models/catalog.py deduplicate network
construction the same way).

The port of ``ray_tpu/rllib/nets.py`` as ``nn.Module``s. A ``Net`` keeps
the reference's parameter names: trunk layer ``i`` is ``w{i}``/``b{i}``
and head ``h`` is ``w_{h}``/``b_{h}`` (``Net.linears``), which is how
``ray_tpu_torch.bridge.rl_params_from_jax``/``rl_params_to_jax`` carry
the reference's flat ``x @ W`` dicts in and out. Weights are drawn from
an explicit CPU ``torch.Generator``, so a seed builds the same net on
every device.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def _linear(generator: torch.Generator, in_dim: int, out_dim: int,
            scale: float) -> nn.Linear:
    """An ``nn.Linear`` whose (in, out) weight is N(0, 1) * scale, drawn
    from ``generator``, and whose bias is 0 (``skip_init`` leaves the
    global RNG alone)."""
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    with torch.no_grad():
        w = torch.randn((in_dim, out_dim), generator=generator) * scale
        lin.weight.copy_(w.t())
        lin.bias.zero_()
    return lin


class Net(nn.Module):
    """Hidden layers for sizes=(in, h1, ..., hn), each tanh(x @ W + b)
    with He init (N(0, 2 / fan_in)), and linear heads named in ``heads``
    (name -> (out_dim, init scale); the reference uses 0.01 for policy
    and Q heads, 1.0 for value heads)."""

    def __init__(self, generator: torch.Generator, sizes: Sequence[int],
                 heads: Dict[str, Tuple[int, float]]):
        super().__init__()
        self.trunk = nn.ModuleList(
            _linear(generator, sizes[i], sizes[i + 1],
                    float(np.sqrt(2 / sizes[i])))
            for i in range(len(sizes) - 1))
        self.heads = nn.ModuleDict(
            {name: _linear(generator, sizes[-1], out, scale)
             for name, (out, scale) in heads.items()})

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """obs (B, obs_dim) -> features (B, hidden[-1])."""
        for lin in self.trunk:
            x = torch.tanh(lin(x))
        return x

    def linears(self) -> Dict[str, nn.Linear]:
        """The reference's key suffix -> layer: ``"0"``, ``"1"``, ... for
        the trunk (``w0``/``b0``), ``"_pi"`` for head ``pi``."""
        out = {str(i): lin for i, lin in enumerate(self.trunk)}
        out.update({f"_{name}": lin for name, lin in self.heads.items()})
        return out


class Adam:
    """What ``optax.adam(lr)`` computes: b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root of the bias-corrected second moment
    (``tests/test_torch_rllib.py`` holds it to optax).

    The parameters are moved into one flat buffer, and their ``.grad``s
    into another, as views that ``backward`` accumulates into (grads are
    zeroed, never set to None). So a step is eight whole-buffer ops,
    whatever the number of tensors, on the card and on the CPU alike:
    the learners take hundreds of tiny steps per iteration (SAC's 400 in
    the reference's test), where per-tensor optimizer work would
    dominate. Move the module to its device before building this."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        p0 = self.params[0]
        n = sum(p.numel() for p in self.params)
        self.flat = torch.empty(n, device=p0.device, dtype=p0.dtype)
        self.grad = torch.zeros_like(self.flat)
        off = 0
        with torch.no_grad():
            for p in self.params:
                k = p.numel()
                self.flat[off:off + k].copy_(p.reshape(-1))
                p.data = self.flat[off:off + k].view_as(p)
                p.grad = self.grad[off:off + k].view_as(p)
                off += k
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        self.count = 0

    def zero_grad(self) -> None:
        self.grad.zero_()

    def minimize(self, loss: torch.Tensor) -> None:
        """One step on ``loss``'s gradient with respect to this
        optimizer's parameters alone (``backward(inputs=)``: what
        ``jax.grad`` of one tree gives, though the loss may reach other
        nets' parameters too, as SAC's actor loss reaches the critic's)."""
        self.zero_grad()
        loss.backward(inputs=self.params)
        self.step()

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        b1, b2 = self.b1, self.b2
        self.m.mul_(b1).add_(self.grad, alpha=1 - b1)
        self.v.mul_(b2).addcmul_(self.grad, self.grad, value=1 - b2)
        # m_hat / (sqrt(v_hat) + eps) * lr, with the bias corrections
        # folded into two scalars
        denom = self.v.sqrt().div_(math.sqrt(1 - b2 ** self.count))
        self.flat.addcdiv_(self.m, denom.add_(self.eps),
                           value=-self.lr / (1 - b1 ** self.count))


def adam(params: Iterable[torch.Tensor], lr: float) -> Adam:
    """The learners' optimizer: ``optax.adam(lr)`` over ``params``."""
    return Adam(params, lr)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device`` (arrays fetched from the
    object store may be read-only views, which ``from_numpy`` would
    share)."""
    return torch.tensor(x, device=device)
