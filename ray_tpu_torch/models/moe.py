"""Mixture-of-Experts decoder family (Mixtral-style) as a PyTorch
``nn.Module``, forward and loss.

Counterpart of ``ray_tpu/models/moe.py``: the same config fields and
presets, the same routing (top-k with per-row capacity, GShard/Switch
style: dense one-hot ``dispatch`` and ``combine`` of shape (batch, seq,
experts, capacity) feeding batched expert products; a token past its
expert's capacity is dropped) and the same Switch load-balancing aux
loss. The attention half of a layer is Llama's (``models/llama.py``:
RoPE, GQA, K1-K3 on the card through ``ops.attention``), and so are the
norms, the remat policies and the cross-entropy.

Layout: the attention matrices are ``nn.Linear`` (out, in), as in
``LlamaLayer``; the router is a (dim, experts) parameter kept in f32
whatever the model dtype (top-k tie-breaks are dtype-sensitive, as the
JAX package notes); ``w_gate``/``w_up`` are (experts, dim, ffn) and
``w_down`` (experts, ffn, dim), the reference's ``x @ W`` orientation, so
the experts' products are ``einsum`` over the expert dim with no
transpose. The batched products reach the dispatcher as ``aten.bmm``, so
the ``"dots"`` policy (which saves ``aten.mm``) recomputes them, as
JAX's ``checkpoint_dots_with_no_batch_dims`` does. The router and expert
products are plain PyTorch, as the reference's are plain jnp: no Pallas
kernel is involved.

Meshes: the expert axis splits the experts (``param_shardings``), the
others split as for Llama. ``shard_params_for_training`` cuts a ``MoE``
into a ``MeshMoE`` and ``forward``/``loss_fn`` take it with ``mesh=``:
the embedding, attention and loss are ``models/llama.py``'s ``_MeshPass``
(attention replicated over the expert axis, run once per row block,
sequence block, tensor slice and device); the MoE half of a layer routes
each (row, sequence) block once per device, each expert shard runs its
experts on the dispatched tokens with its weights gathered over fsdp,
the experts' outputs are summed over tensor and gathered over the expert
axis, and each block combines them all in one product, as one device
does. Capacity positions count over
the whole row and the aux loss over the whole batch, as the JAX
package's global semantics give them, also with the sequence split over
context.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import (MeshAxes, _rmsnorm, _rope_tables,
                                        cross_entropy)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    logits_dtype: str = "float32"
    attn_impl: str = "auto"
    attn_block_q: int = 128
    attn_block_k: int = 128

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def capacity(self, seq_len: int) -> int:
        """Per-row expert capacity (tokens per expert per sequence)."""
        c = int(self.capacity_factor * self.experts_per_token * seq_len
                / self.n_experts)
        return max(4, -(-c // 4) * 4)  # round up to a multiple of 4

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
        moe = d * self.n_experts + 3 * self.n_experts * d * f
        per_layer = attn + moe + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    def num_active_params(self) -> int:
        """Params touched per token (top-k experts, not all)."""
        d, f = self.dim, self.ffn_dim
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
        moe = d * self.n_experts + 3 * self.experts_per_token * d * f
        per_layer = attn + moe + 2 * d
        return self.vocab_size * d + self.n_layers * per_layer \
            + d + d * self.vocab_size

    def flops_per_token(self, seq_len: int) -> float:
        n_matmul = self.num_active_params() - self.vocab_size * self.dim
        attn = 12 * self.n_layers * self.dim * seq_len
        return 6.0 * n_matmul + attn

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def mixtral_8x7b(**kw) -> MoEConfig:
    return MoEConfig(**kw)


def tiny(**kw) -> MoEConfig:
    defaults = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, ffn_dim=128, n_experts=4,
                    experts_per_token=2, max_seq_len=128)
    defaults.update(kw)
    return MoEConfig(**defaults)


# --- module ------------------------------------------------------------------


class MoELayer(nn.Module):
    def __init__(self, cfg: MoEConfig, **factory):
        super().__init__()
        d, f, E = cfg.dim, cfg.ffn_dim, cfg.n_experts
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.attn_norm = nn.Parameter(torch.empty(d, **factory))
        self.wq = nn.Linear(d, h * hd, bias=False, **factory)
        self.wk = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wv = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wo = nn.Linear(h * hd, d, bias=False, **factory)
        self.mlp_norm = nn.Parameter(torch.empty(d, **factory))
        self.router = nn.Parameter(torch.empty(
            d, E, device=factory["device"], dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(E, d, f, **factory))
        self.w_up = nn.Parameter(torch.empty(E, d, f, **factory))
        self.w_down = nn.Parameter(torch.empty(E, f, d, **factory))


class MoE(nn.Module):
    """The decoder's parameters: ``embed``, ``layers[i]``,
    ``final_norm``, ``lm_head``. Built on the meta device by default and
    filled by ``init_params`` or the bridge."""

    def __init__(self, cfg: MoEConfig, *, device="meta",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        factory = dict(device=device, dtype=dtype or cfg.torch_dtype)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **factory)
        self.layers = nn.ModuleList(
            MoELayer(cfg, **factory) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, **factory))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                 **factory)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.weight.dtype

    def forward(self, tokens: torch.Tensor):
        return forward(self, tokens)


def empty_model(cfg: MoEConfig, device: Union[str, torch.device],
                dtype: Optional[torch.dtype] = None) -> MoE:
    """A MoE with uninitialised storage on ``device`` (no parameter
    requires grad)."""
    model = MoE(cfg, dtype=dtype).to_empty(device=device)
    return model.requires_grad_(False)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: MoEConfig,
                device: Union[str, torch.device, None] = None,
                dtype: Optional[torch.dtype] = None, *,
                trainable: bool = False) -> MoE:
    """Random weights as ``ray_tpu.models.moe.init_params`` draws them:
    normal(0, 1) * fan_in^-0.5 in f32, cast to the model dtype; norms at
    one; the router stays f32. ``device=None`` is the CUDA device, and
    raises when there is none; ``generator`` must live on the same kind
    of device. The numbers differ from jax.random's for the same seed."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on "
                         f"{dev}: make the generator on {dev.type}")
    model = empty_model(cfg, dev, dtype)

    def draw(shape, fan_in: int) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * (fan_in ** -0.5)

    d, f = cfg.dim, cfg.ffn_dim
    model.embed.weight.copy_(draw((cfg.vocab_size, d), d))
    for lyr in model.layers:
        lyr.attn_norm.fill_(1.0)
        lyr.mlp_norm.fill_(1.0)
        for lin, fan_in in ((lyr.wq, d), (lyr.wk, d), (lyr.wv, d),
                            (lyr.wo, cfg.n_heads * cfg.head_dim)):
            # drawn in the JAX tree's (in, out) order, stored (out, in)
            lin.weight.copy_(draw(lin.weight.shape[::-1], fan_in).t())
        lyr.router.copy_(draw(lyr.router.shape, d))
        for w, fan_in in ((lyr.w_gate, d), (lyr.w_up, d), (lyr.w_down, f)):
            w.copy_(draw(w.shape, fan_in))
    model.final_norm.fill_(1.0)
    model.lm_head.weight.copy_(draw((d, cfg.vocab_size), d).t())
    return llama.finish(model, trainable)


# --- sharding over a mesh ------------------------------------------------------


def param_shardings(cfg: MoEConfig, axes: MeshAxes = MeshAxes()) -> dict:
    """The JAX package's layout (``ray_tpu/models/moe.py``
    ``param_shardings``) over the port's tensors, one entry per dim
    naming the mesh axis that splits it (None: whole), as
    ``llama.param_shardings``: the attention's and the embeddings' are
    Llama's, the router splits its width over fsdp, each expert tensor
    its experts over the expert axis, its width over fsdp and its ffn
    over tensor."""
    t, fs, ep = axes.tensor, axes.fsdp, axes.expert
    specs = llama.param_shardings(cfg, axes)
    layers = {n: specs["layers"][n] for n in ("attn_norm", "wq", "wk", "wv",
                                              "wo", "mlp_norm")}
    layers.update(router=(fs, None), w_gate=(ep, fs, t), w_up=(ep, fs, t),
                  w_down=(ep, t, fs))
    return dict(specs, layers=layers)


class _ExpertLayer(nn.Module):
    def __init__(self, cfg: MoEConfig, ep: int, fsdp: int, tp: int,
                 **factory):
        super().__init__()
        e, d, f = cfg.n_experts // ep, cfg.dim // fsdp, cfg.ffn_dim // tp
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **factory))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **factory))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **factory))


class _Experts(nn.Module):
    """One (expert, fsdp, tensor) block of every layer's expert tensors."""

    def __init__(self, cfg: MoEConfig, ep: int, fsdp: int, tp: int,
                 **factory):
        super().__init__()
        self.layers = nn.ModuleList(_ExpertLayer(cfg, ep, fsdp, tp, **factory)
                                    for _ in range(cfg.n_layers))


class _RouterLayer(nn.Module):
    def __init__(self, cfg: MoEConfig, fsdp: int, device):
        super().__init__()
        self.router = nn.Parameter(torch.empty(
            cfg.dim // fsdp, cfg.n_experts, device=device,
            dtype=torch.float32))


class _Routers(nn.Module):
    """One fsdp block of every layer's router."""

    def __init__(self, cfg: MoEConfig, fsdp: int, device):
        super().__init__()
        self.layers = nn.ModuleList(_RouterLayer(cfg, fsdp, device)
                                    for _ in range(cfg.n_layers))


class MeshMoE(llama.MeshLlama):
    """A ``MoE`` split over a ``DeviceMesh`` for training, per
    ``param_shardings``: ``blocks[f * tp + t]`` holds the attention
    matrices' and embeddings' block (f, t) and ``norms`` the norms, as in
    ``MeshLlama``; ``routers[f]`` holds the routers' fsdp block f (f32)
    on the device of the first mesh shard with fsdp coordinate f;
    ``experts[(e * fsdp + f) * tp + t]`` holds block (e, f, t) of every
    expert tensor, on the device of the first shard with those
    coordinates."""

    def __init__(self, cfg: MoEConfig, mesh, axes: MeshAxes = MeshAxes(),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cfg, mesh, axes, dtype, dense=False)
        self.ep = mesh.shape[axes.expert]
        factory = dict(device="meta", dtype=dtype or cfg.torch_dtype)
        self.routers = nn.ModuleList(
            _Routers(cfg, self.fsdp, "meta").to_empty(
                device=mesh.devices[mesh.index({axes.fsdp: f})])
            for f in range(self.fsdp))
        experts = []
        for e in range(self.ep):
            for f in range(self.fsdp):
                for t in range(self.tp):
                    home = mesh.devices[mesh.index({
                        axes.expert: e, axes.fsdp: f, axes.tensor: t})]
                    experts.append(_Experts(cfg, self.ep, self.fsdp, self.tp,
                                            **factory).to_empty(device=home))
        self.experts = nn.ModuleList(experts)

    def expert_block(self, e: int, f: int, t: int) -> _Experts:
        return self.experts[(e * self.fsdp + f) * self.tp + t]

    def specs(self) -> dict:
        return param_shardings(self.cfg, self.axes)

    def whole(self) -> nn.Module:
        return MoE(self.cfg)

    def coords(self, scope: str, k: int) -> dict:
        ax = self.axes
        if scope == "routers":
            return {ax.fsdp: k}
        if scope == "experts":
            return {ax.expert: k // (self.fsdp * self.tp),
                    ax.fsdp: k // self.tp % self.fsdp, ax.tensor: k % self.tp}
        return super().coords(scope, k)


@torch.no_grad()
def shard_params_for_training(model: MoE, mesh, axes: MeshAxes = MeshAxes(),
                              *, trainable: bool = True) -> MeshMoE:
    """``model`` cut per ``param_shardings`` over ``mesh``: each block a
    copy of its slice, a leaf parameter requiring grad (``trainable``).
    The expert axis must divide the experts; fsdp the width; tensor the
    heads, kv heads, ffn and vocab."""
    cfg = model.cfg
    tp, fsdp = mesh.shape[axes.tensor], mesh.shape[axes.fsdp]
    ep = mesh.shape[axes.expert]
    for name, n, by, axis in (("n_experts", cfg.n_experts, ep, axes.expert),
                              ("n_heads", cfg.n_heads, tp, axes.tensor),
                              ("n_kv_heads", cfg.n_kv_heads, tp,
                               axes.tensor),
                              ("ffn_dim", cfg.ffn_dim, tp, axes.tensor),
                              ("vocab_size", cfg.vocab_size, tp,
                               axes.tensor),
                              ("dim", cfg.dim, fsdp, axes.fsdp)):
        if n % by:
            raise ValueError(f"{name}={n} not divisible by the mesh's "
                             f"{axis} size {by}")
    out = MeshMoE(cfg, mesh, axes, dtype=model.dtype)
    full = dict(model.named_parameters())
    for p, (name, idx) in zip(out.parameters(), out.layout()):
        p.copy_(full[name][idx])
    out.requires_grad_(trainable)
    return out.train() if trainable else out.eval()


# --- routing -------------------------------------------------------------------


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``'s choice: the k largest, largest first, the lower
    expert first among equals (a stable sort; ``torch.topk`` promises no
    order for ties). The values carry the gradient; the indices none."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def _routing(y: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
             capacity: int, starts: Optional[List[torch.Tensor]] = None):
    """Top-k routing of ``y`` (b, s, d) with ``capacity`` slots per
    expert -> ``dispatch`` (b, s, E, C) f32 (one at each kept token's
    slot), ``combine`` (b, s, E, C) f32 (its gate weight there), the
    router's ``probs`` (b, s, E) f32 and the chosen experts ``idx`` (b, s,
    k). A token's slot is its place in its expert's queue over the row,
    choice by choice (all of choice 0 before choice 1); ``starts[j]`` (b,
    1, E), when given, is the slots of each expert taken before this
    block's first token at choice j (the row's earlier choices, and
    choice j in its earlier sequence blocks); by default the block is the
    whole row."""
    b, s, _ = y.shape
    E, k, C = cfg.n_experts, cfg.experts_per_token, capacity
    probs = torch.softmax(y.float() @ router, dim=-1)
    gate_vals, idx = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    slots = torch.arange(C, device=y.device)
    dispatch = combine = None
    used = torch.zeros((b, 1, E), dtype=torch.float32, device=y.device)
    for j in range(k):
        m = F.one_hot(idx[..., j], E).float()               # (b, s, E)
        pos = torch.cumsum(m, dim=1) - m + (
            used if starts is None else starts[j])
        keep = m * (pos < C)
        pos_oh = (pos.clamp(0, C - 1).long()[..., None] == slots).float()
        d_j = keep[..., None] * pos_oh
        c_j = (gate_vals[..., j, None] * keep)[..., None] * pos_oh
        dispatch = d_j if dispatch is None else dispatch + d_j
        combine = c_j if combine is None else combine + c_j
        used = used + keep.sum(dim=1, keepdim=True)
    return dispatch, combine, probs, idx


def _counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """(E,) f32: the top-k assignments to each expert."""
    return F.one_hot(idx, E).float().sum(dim=(0, 1, 2))


def _route(y: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Top-k routing with per-row capacity (``ray_tpu.models.moe._route``).

    y: (b, s, d) -> dispatch (b, s, E, C), combine (b, s, E, C) with gate
    weights, both f32, and the aux load-balance loss (f32 0-d): E * sum_e
    f_e * p_e, f_e the share of the top-k assignments to expert e and p_e
    its mean router probability."""
    E = cfg.n_experts
    dispatch, combine, probs, idx = _routing(y, router, cfg,
                                             cfg.capacity(y.shape[1]))
    f_e = F.one_hot(idx, E).float().sum(dim=2).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    return dispatch, combine, E * torch.sum(f_e * p_e)


def _experts(xd: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Dispatched tokens (b, e, C, d) through each of the e experts'
    SwiGLU -> (b, e, C, d): products batched over the expert dim."""
    gate = F.silu(torch.einsum("becd,edf->becf", xd, w_gate))
    up = torch.einsum("becd,edf->becf", xd, w_up)
    return torch.einsum("becf,efd->becd", gate * up, w_down)


def _moe_block(y: torch.Tensor, lyr: MoELayer, cfg: MoEConfig):
    """y: (b, s, d) normed hidden -> (expert-mixed output (b, s, d), aux).
    ``dispatch`` and ``combine`` are cast to the hidden dtype before
    their products, as the reference casts them."""
    dispatch, combine, aux = _route(y, lyr.router, cfg)
    dt = y.dtype
    xd = torch.einsum("bsec,bsd->becd", dispatch.to(dt), y)
    out = _experts(xd, lyr.w_gate, lyr.w_up, lyr.w_down)
    return torch.einsum("bsec,becd->bsd", combine.to(dt), out), aux


# --- forward -------------------------------------------------------------------


def _layer(lyr: MoELayer, x: torch.Tensor, rc: torch.Tensor,
           rs: torch.Tensor, cfg: MoEConfig, impl: str):
    x = llama._attn_block(lyr, x, rc, rs, cfg, impl)
    out, aux = _moe_block(_rmsnorm(x, lyr.mlp_norm, cfg.norm_eps), lyr, cfg)
    return x + out, aux


def forward(model: MoE, tokens: torch.Tensor,
            cfg: Optional[MoEConfig] = None, mesh=None,
            axes: MeshAxes = MeshAxes()):
    """tokens (b, s) -> (logits (b, s, vocab) in ``cfg.logits_dtype``,
    aux loss f32 0-d: the sum over layers). ``cfg`` defaults to
    ``model.cfg``. With grad enabled each layer is rematerialised per
    ``cfg.remat``/``cfg.remat_policy`` (``llama._remat``). With a mesh of
    more than one device ``model`` is a ``MeshMoE`` on it and both are
    on the mesh's first device."""
    cfg = model.cfg if cfg is None else cfg
    dtype = getattr(torch, cfg.logits_dtype)
    if llama._sharded(model, mesh):
        ps = _MoEPass(model, cfg)
        hs = ps.hidden(ps.split({"tokens": tokens})["tokens"])
        lm = ps.lm_heads()
        logits = ps.assemble({ps.key[g[0]]: llama._group_logits(
            [hs[ps.key[j]] for j in g], [lm[j] for j in g],
            ps.devs[g[0]]).to(dtype) for g in ps.vocab_groups()})
        return logits, ps.aux_loss()
    b, s = tokens.shape
    impl = "auto" if cfg.attn_impl == "ring" else cfg.attn_impl
    remat = llama._remat(cfg) if torch.is_grad_enabled() else None
    x = model.embed(tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    rc, rs = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    aux = []
    for lyr in model.layers:
        if remat is not None:
            x, a = checkpoint(_layer, lyr, x, rc, rs, cfg, impl,
                              use_reentrant=False, **remat)
        else:
            x, a = _layer(lyr, x, rc, rs, cfg, impl)
        aux.append(a)
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    return model.lm_head(x).to(dtype), torch.stack(aux).sum()


def loss_fn(model: MoE, batch: dict, cfg: Optional[MoEConfig] = None,
            mesh=None, axes: MeshAxes = MeshAxes()) -> torch.Tensor:
    """Cross-entropy + weighted load-balance aux loss (f32 0-d). With a
    mesh of more than one device ``model`` is a ``MeshMoE`` on it and
    ``batch`` holds the whole arrays or every shard's blocks
    (``llama.shard_batch``), as for Llama."""
    cfg = model.cfg if cfg is None else cfg
    if llama._sharded(model, mesh):
        ps = _MoEPass(model, cfg)
        ce = llama._mesh_loss(ps, batch, cfg)
        return ce + cfg.aux_loss_weight * ps.aux_loss()
    logits, aux = forward(model, batch["tokens"], cfg)
    return cross_entropy(logits, batch) + cfg.aux_loss_weight * aux


# --- the MoE half of a layer over a mesh ---------------------------------------


class _MoEPass(llama._MeshPass):
    """``llama._MeshPass`` with the MoE half of each layer in place of
    the MLP's; ``aux`` collects each layer's aux loss."""

    def __init__(self, model: MeshMoE, cfg: MoEConfig):
        super().__init__(model, cfg)
        self.aux: List[torch.Tensor] = []
        # each (row, sequence) block's first key: its routing statistics
        # count once in the aux loss
        self.rows: dict = {}
        for k in self.lead:
            self.rows.setdefault(k[:2], k)

    def layer(self, i: int, xs: dict, ropes: dict, remat) -> dict:
        """Layer i: the attention half (Llama's), then the MoE half in two
        regions per device: routing, dispatch and each expert shard's
        experts (``_expert_region``); between them the experts' outputs
        summed over tensor (w_down's partials) and gathered over the
        expert axis; then each key's combine over all the experts
        (``_combine_region``), added to its stream."""
        xs = llama._mesh_attn(self, i, xs, ropes, remat)
        starts = _capacity_starts(self, i, xs) if self.cp > 1 else None
        out = self.per_device(remat, _expert_region, i, xs, starts)
        self.aux.append(self._aux([out[k][1:] for k in self.rows.values()]))
        o = self.mesh.all_reduce([out[j] for j in range(self.mesh.size)],
                                 self.ax.tensor)
        o = self.mesh.all_gather(o, self.ax.expert, 1)
        moe_out = self.per_device(remat, _combine_region, o,
                                  {k: out[k][0] for k in self.lead})
        return {k: xs[k] + moe_out[k] for k in self.lead}

    def aux_loss(self) -> torch.Tensor:
        """The sum of the layers' aux losses, on the mesh's first
        device."""
        return torch.stack(self.aux).sum()

    def _aux(self, stats: list) -> torch.Tensor:
        """E * sum_e f_e * p_e over the whole batch, from each (row,
        sequence) block's assignment counts and probability sums, added
        on the mesh's first device in block order."""
        dev = self.devs[0]
        cnt = psum = None
        n = 0
        for c, p, tokens in stats:
            cnt = c.to(dev) if cnt is None else cnt + c.to(dev)
            psum = p.to(dev) if psum is None else psum + p.to(dev)
            n += tokens
        return self.cfg.n_experts * torch.sum((cnt / n) * (psum / n))

    def router(self, dev: torch.device, i: int) -> torch.Tensor:
        """Layer i's router gathered over fsdp, on ``dev``."""
        parts = [r.layers[i].router.to(dev) for r in self.model.routers]
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

    def expert_weights(self, dev: torch.device, i: int) -> dict:
        """{(e, t): layer i's (w_gate, w_up, w_down) of expert block e and
        tensor slice t gathered over fsdp, on ``dev``} for the shards
        there."""
        out = {}
        for e, t in sorted({(self.co[j].get(self.ax.expert, 0),
                             self.co[j][self.ax.tensor])
                            for j in self.on[dev]}):
            ws = []
            for name, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
                parts = [getattr(self.model.expert_block(e, f, t).layers[i],
                                 name).to(dev) for f in range(self.fsdp)]
                ws.append(parts[0] if len(parts) == 1
                          else torch.cat(parts, dim))
            out[e, t] = tuple(ws)
        return out

    def route_inputs(self, dev: torch.device, i: int, xs: dict):
        """The MoE half's normed input of each key on ``dev`` and layer
        i's router there."""
        return (self.norm(xs, self.model.norms.layers[i].mlp_norm, dev),
                self.router(dev, i))


def _expert_region(ps: _MoEPass, dev: torch.device, i: int, xs: dict,
                   starts: Optional[dict]) -> dict:
    """{shard on ``dev``: its experts' outputs (b, e, C, d), partial over
    the tensor slices}; {key on ``dev``: (combine (b, s, E, C) in the
    hidden dtype, assignment counts (E,), probability sums (E,),
    tokens)}. Routing and the dispatch product run once per key; the
    shards there of one expert block and tensor slice run their experts
    in one batched product over all their rows (each shard takes its
    experts' slice of its key's dispatched tokens), with the weights
    gathered over fsdp."""
    cfg = ps.cfg
    E = cfg.n_experts
    e_loc = E // ps.ep
    ys, router = ps.route_inputs(dev, i, xs)
    xd, out = {}, {}
    for key, y in ys.items():
        b, s, _ = y.shape
        dispatch, combine, probs, idx = _routing(
            y, router, cfg, cfg.capacity(s * ps.cp),
            None if starts is None else starts[key])
        xd[key] = torch.einsum("bsec,bsd->becd", dispatch.to(y.dtype), y)
        out[key] = (combine.to(y.dtype), _counts(idx, E),
                    probs.sum(dim=(0, 1)), b * s)
    w = ps.expert_weights(dev, i)
    blocks: dict = {}
    for j in ps.on[dev]:
        blocks.setdefault((ps.co[j].get(ps.ax.expert, 0),
                           ps.co[j][ps.ax.tensor]), []).append(j)
    for (e, t), js in blocks.items():
        blk = slice(e * e_loc, (e + 1) * e_loc)
        parts = [xd[ps.key[j]][:, blk] for j in js]
        o = _experts(parts[0] if len(parts) == 1 else torch.cat(parts, 0),
                     *w[e, t])
        out.update(zip(js, o.split([x.shape[0] for x in parts], 0)))
    return out


def _combine_region(ps: _MoEPass, dev: torch.device, o: list,
                    combine: dict) -> dict:
    """{key on ``dev``: its MoE output (b, s, d)}: the combine product
    over every expert's outputs (``o[j]``, gathered over the expert axis,
    summed over tensor, for the key's first shard j)."""
    return {k: torch.einsum("bsec,becd->bsd", c, o[ps.lead[k]])
            for k, c in combine.items() if k[2] == dev}


@torch.no_grad()
def _capacity_starts(ps: _MoEPass, i: int, xs: dict) -> dict:
    """{key: [per choice j, (b, 1, E) f32 on the key's device: the slots
    of each expert its row took before the key's first token]}, for a
    sequence split over context: the row's kept assignments of choices
    before j (over all its sequence blocks; at most the capacity), plus
    choice j's assignments in the earlier sequence blocks. Computed from
    each block's top-k choices (which carry no gradient) before the
    layer's expert regions, which route again from the same values."""
    cfg = ps.cfg
    E, k = cfg.n_experts, cfg.experts_per_token
    chosen = {}                                # (r, c) -> (b, k, E)
    for rc, key in ps.rows.items():
        ys, router = ps.route_inputs(key[2], i, {key: xs[key]})
        probs = torch.softmax(ys[key].float() @ router, dim=-1)
        _, idx = _top_k(probs, k)
        chosen[rc] = F.one_hot(idx, E).float().sum(dim=1).to(ps.devs[0])
    C = cfg.capacity(xs[next(iter(ps.rows.values()))].shape[1] * ps.cp)
    at: dict = {}
    for r in sorted({rc[0] for rc in ps.rows}):
        used = torch.zeros_like(chosen[r, 0][:, 0])          # (b, E)
        for j in range(k):
            run = used
            for c in range(ps.cp):
                at.setdefault((r, c), []).append(run)
                run = run + chosen[r, c][:, j]
            used = run.clamp(max=C)
    return {key: [a[:, None].to(key[2]) for a in at[key[:2]]]
            for key in ps.lead}
