"""Weight bridge between the JAX package's parameter trees and the port's
``Llama`` and ``MoE`` modules.

The JAX tree (``ray_tpu.models.llama.init_params``) holds ``embed``
(vocab, dim), ``layers`` with every per-layer tensor stacked on a leading
axis, ``final_norm`` and ``lm_head`` (dim, vocab), all in the ``x @ W``
(in, out) orientation. The port's ``nn.Linear`` weights are (out, in):
the transpose happens here and nowhere else. Arrays cross as numpy; bf16
crosses as ``np.asarray(x, np.float32)`` and is cast back with
``.to(torch.bfloat16)``, which is exact both ways.

The MoE tree (``ray_tpu.models.moe.init_params``) stacks its layers the
same way, with the attention's and norms' tensors named as Llama's, the
``router`` (L, dim, experts), kept float32 on both sides, and the experts'
``w_gate``/``w_up`` (L, experts, dim, ffn) and ``w_down`` (L, experts, ffn,
dim), whose orientation the port keeps: only the attention matrices and
the embeddings' are transposed.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.llama import Llama, LlamaConfig, empty_model, finish

# per-layer linear weights: stored transposed in the module
_ATTN = ("wq", "wk", "wv", "wo")
_LINEARS = _ATTN + ("w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")
# the MoE layer's expert tensors: stored as the JAX tree holds them
_EXPERTS = ("w_gate", "w_up", "w_down")


def _t(x, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: LlamaConfig,
                      device: Union[str, torch.device, None] = None,
                      dtype: Optional[torch.dtype] = None, *,
                      trainable: bool = False) -> Llama:
    """The JAX parameter tree (numpy leaves, or anything ``np.asarray``
    takes) -> a ``Llama`` on ``device`` in ``dtype`` (default
    ``cfg.dtype``), for inference or, with ``trainable``, for training.
    ``device=None`` is the CUDA device, and raises when there is none;
    pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    model = empty_model(cfg, device, dtype)
    model.embed.weight.copy_(_t(tree["embed"], device, dtype))
    layers = tree["layers"]
    for i, lyr in enumerate(model.layers):
        for name in _NORMS:
            getattr(lyr, name).copy_(_t(layers[name][i], device, dtype))
        for name in _LINEARS:
            getattr(lyr, name).weight.copy_(
                _t(layers[name][i], device, dtype).t())
    model.final_norm.copy_(_t(tree["final_norm"], device, dtype))
    model.lm_head.weight.copy_(_t(tree["lm_head"], device, dtype).t())
    return finish(model, trainable)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


def _grad(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if p.grad is None else p.grad


def _tree(model: Llama, leaf) -> dict:
    """The JAX tree layout of ``leaf(parameter)`` over the model, as
    float32 numpy arrays."""
    layers = {}
    for name in _NORMS:
        layers[name] = np.stack([_np(leaf(getattr(l, name)))
                                 for l in model.layers])
    for name in _LINEARS:
        layers[name] = np.stack([_np(leaf(getattr(l, name).weight)).T
                                 for l in model.layers])
    return {"embed": _np(leaf(model.embed.weight)), "layers": layers,
            "final_norm": _np(leaf(model.final_norm)),
            "lm_head": _np(leaf(model.lm_head.weight)).T}


@torch.no_grad()
def params_to_numpy(model: Llama) -> dict:
    """A ``Llama`` -> the JAX parameter tree as float32 numpy arrays
    (stacked layers, ``x @ W`` orientation). Casting the leaves to the
    model's dtype on the JAX side restores them exactly."""
    return _tree(model, lambda p: p)


@torch.no_grad()
def grads_to_numpy(model: Llama) -> dict:
    """The parameters' ``.grad`` in the JAX tree layout (float32 numpy;
    a parameter without a grad gives zeros): the counterpart of the
    gradient tree ``jax.grad`` returns for the same parameters."""
    return _tree(model, _grad)


@torch.no_grad()
def moe_params_from_numpy(tree: dict, cfg: "moe.MoEConfig",
                          device: Union[str, torch.device, None] = None,
                          dtype: Optional[torch.dtype] = None, *,
                          trainable: bool = False) -> "moe.MoE":
    """The JAX MoE parameter tree -> a ``MoE`` on ``device`` in ``dtype``
    (default ``cfg.dtype``; the routers stay float32), for inference or,
    with ``trainable``, for training. ``device=None`` is the CUDA
    device."""
    device = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    model = moe.empty_model(cfg, device, dtype)
    model.embed.weight.copy_(_t(tree["embed"], device, dtype))
    layers = tree["layers"]
    for i, lyr in enumerate(model.layers):
        for name in _NORMS + _EXPERTS:
            getattr(lyr, name).copy_(_t(layers[name][i], device, dtype))
        for name in _ATTN:
            getattr(lyr, name).weight.copy_(
                _t(layers[name][i], device, dtype).t())
        lyr.router.copy_(_t(layers["router"][i], device, torch.float32))
    model.final_norm.copy_(_t(tree["final_norm"], device, dtype))
    model.lm_head.weight.copy_(_t(tree["lm_head"], device, dtype).t())
    return finish(model, trainable)


def _moe_tree(model: "moe.MoE", leaf) -> dict:
    """The JAX MoE tree layout of ``leaf(parameter)`` over the model, as
    float32 numpy arrays."""
    layers = {}
    for name in _NORMS + _EXPERTS + ("router",):
        layers[name] = np.stack([_np(leaf(getattr(l, name)))
                                 for l in model.layers])
    for name in _ATTN:
        layers[name] = np.stack([_np(leaf(getattr(l, name).weight)).T
                                 for l in model.layers])
    return {"embed": _np(leaf(model.embed.weight)), "layers": layers,
            "final_norm": _np(leaf(model.final_norm)),
            "lm_head": _np(leaf(model.lm_head.weight)).T}


@torch.no_grad()
def moe_params_to_numpy(model: "moe.MoE") -> dict:
    """A ``MoE`` -> the JAX MoE parameter tree as float32 numpy arrays."""
    return _moe_tree(model, lambda p: p)


@torch.no_grad()
def moe_grads_to_numpy(model: "moe.MoE") -> dict:
    """The parameters' ``.grad`` in the JAX MoE tree layout (float32
    numpy; a parameter without a grad gives zeros)."""
    return _moe_tree(model, _grad)
