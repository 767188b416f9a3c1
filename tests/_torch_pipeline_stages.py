"""Torch pipeline stages shared by the pipeline tests: a Llama stage over
the port's model pieces (``llama._layer``, ``_rmsnorm``,
``_rope_tables``, ``fused_cross_entropy``) through
``torch.func.functional_call``, its parameters cut from a whole model,
and ``optax.sgd`` in optax's shape over tensors. Registered with
cloudpickle by value, so the runtime's workers rebuild these from their
bytes instead of importing this module."""

import functools
import sys

import cloudpickle
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.dag.ring import _map_leaves

cloudpickle.register_pickle_by_value(sys.modules[__name__])


class SGD:
    """``optax.sgd(lr)`` in optax's shape over torch tensors: the update
    is ``-lr * g``."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        return _map_leaves(grads,
                           lambda g: None if g is None else -self.lr * g), \
            state


class LlamaStage(nn.Module):
    """One pipeline stage of the port's Llama over parameters handed in
    by ``functional_call``: the embedding on the first stage, ``n``
    decoder layers (``llama._layer``), and on the last stage the final
    norm, ``lm_head`` and the chunked cross-entropy. Built on the meta
    device: it only names the parameters."""

    def __init__(self, cfg, n: int, first: bool, last: bool):
        from ray_tpu_torch.models.llama import LlamaLayer
        super().__init__()
        factory = dict(device="meta", dtype=cfg.torch_dtype)
        self.cfg, self.first, self.last = cfg, first, last
        if first:
            self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **factory)
        self.layers = nn.ModuleList(LlamaLayer(cfg, **factory)
                                    for _ in range(n))
        if last:
            self.final_norm = nn.Parameter(torch.empty(cfg.dim, **factory))
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                     **factory)

    def forward(self, x, targets):
        from ray_tpu_torch.models import llama
        cfg = self.cfg
        if self.first:
            x = self.embed(x)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        rc, rs = llama._rope_tables(pos[None].expand(b, s), cfg.head_dim,
                                    cfg.rope_theta)
        for lyr in self.layers:
            x = llama._layer(lyr, x, rc, rs, cfg, "auto")
        if not self.last:
            return x, targets
        x = llama._rmsnorm(x, self.final_norm, cfg.norm_eps)
        # the head as a function of the tensor functional_call handed
        # in: the loss's checkpointed chunks recompute after the call
        # has put the meta parameter back
        head = functools.partial(F.linear, weight=self.lm_head.weight)
        return llama.fused_cross_entropy(x, head, {"targets": targets}, s,
                                         cfg.logits_dtype)


def llama_stage_fn(cfg, n, first, last, params, payload):
    body = LlamaStage(cfg, n, first, last)
    return torch.func.functional_call(body, params, tuple(payload))


def llama_stage_params(model, lo: int, hi: int, first: bool, last: bool):
    """Stage parameters as a flat dict named like LlamaStage's, from the
    port's whole model (layers [lo, hi))."""
    out = {}
    if first:
        out["embed.weight"] = model.embed.weight.detach().clone()
    for j, i in enumerate(range(lo, hi)):
        for name, p in model.layers[i].named_parameters():
            out[f"layers.{j}.{name}"] = p.detach().clone()
    if last:
        out["final_norm"] = model.final_norm.detach().clone()
        out["lm_head.weight"] = model.lm_head.weight.detach().clone()
    return out
