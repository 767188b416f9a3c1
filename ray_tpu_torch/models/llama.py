"""Llama-family decoder as a PyTorch ``nn.Module``, forward and loss.

Counterpart of ``ray_tpu/models/llama.py``: the same config fields and
presets, the same layer (``attn_norm``, ``wq/wk/wv/wo``, ``mlp_norm``,
``w_gate/w_up/w_down``) and the same numerics (f32 RMS statistics, RoPE
tables computed once per forward, rotate-half RoPE in the working dtype).
Projections are ``nn.Linear`` in the (out, in) layout; the weight bridge
(``ray_tpu_torch/bridge.py``) is the one place that transposes from the
JAX package's ``x @ W`` layout.

Training: ``forward_hidden``/``forward``/``loss_fn`` are differentiable
(inference callers hold their own ``no_grad``); per-layer remat is
``torch.utils.checkpoint`` under the JAX package's four policies
(``_remat``): ``"full"`` (the default) recomputes the whole layer,
``"attn"`` and ``"dots"`` save some outputs by selective checkpointing,
``remat=False``/``"none"`` saves everything; the masked
``cross_entropy`` and the chunked, per-chunk-checkpointed
``fused_cross_entropy`` (``ce_chunk > 0``) are the JAX package's.

Meshes (data, fsdp, tensor and context axes; ``parallel.mesh.DeviceMesh``):
``param_shardings`` is the JAX package's layout on the port's (out, in)
weights and ``shard_params_for_training`` cuts a ``Llama`` into a
``MeshLlama``, one leaf parameter per (fsdp, tensor) block on the device
of the first shard holding it, the norms once on the mesh's first
device. ``forward_hidden``/``forward``/``loss_fn`` take ``mesh=`` and
``axes=`` and follow the JAX activation layout ``P(batch, context,
None)``: shard (d, f, t, c) runs batch block (d, f) and sequence block c
on tensor slice t. One process drives every shard in one autograd graph,
so the collectives (``DeviceMesh.all_gather``/``all_reduce``, moves by
``.to()``) are differentiated by autograd: a gathered weight's gradient
is summed over its users into the block, a replicated input's over the
shards that read it. Remat regions are per layer, block and device (the
collectives run between them), so a region never spans two cards.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # training knobs of the JAX package, kept field for field so configs
    # cross unchanged (attn_block_q/k size the TPU kernel's tiles and are
    # not read here)
    remat: bool = True
    remat_policy: str = "full"
    logits_dtype: str = "float32"
    ce_chunk: int = 0
    attn_impl: str = "auto"        # auto | flash | reference | ring
    attn_block_q: int = 128
    attn_block_k: int = 128

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = d * h * hd + 2 * d * kvh * hd + h * hd * d \
            + 3 * d * f + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token (fwd+bwd ~ 6*N plus attention term), as
        the JAX package counts them: the embedding is a gather and
        rematerialised forwards are not counted."""
        n_matmul = self.num_params() - self.vocab_size * self.dim
        attn = 12 * self.n_layers * self.dim * seq_len
        return 6.0 * n_matmul + attn

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def llama2_7b(**kw) -> LlamaConfig:
    defaults = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=32, ffn_dim=11008, max_seq_len=4096)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def llama2_13b(**kw) -> LlamaConfig:
    defaults = dict(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                    ffn_dim=13824)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def llama3_8b(**kw) -> LlamaConfig:
    defaults = dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, ffn_dim=14336, rope_theta=500000.0,
                    max_seq_len=8192)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def tiny(**kw) -> LlamaConfig:
    defaults = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                    n_kv_heads=2, ffn_dim=256, max_seq_len=256)
    defaults.update(kw)
    return LlamaConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The mesh's axis names, as the JAX package's ``MeshAxes``: the
    batch splits over (data, fsdp), the sequence over context; heads, ffn
    and vocab over tensor, the model width of the weights over fsdp."""
    data: str = "data"
    fsdp: str = "fsdp"
    tensor: str = "tensor"
    context: str = "context"
    expert: str = "expert"   # the MoE family's experts (models/moe.py)

    @property
    def batch(self):
        return (self.data, self.fsdp)


# --- module ------------------------------------------------------------------


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        d, f = cfg.dim, cfg.ffn_dim
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.attn_norm = nn.Parameter(torch.empty(d, **factory))
        self.wq = nn.Linear(d, h * hd, bias=False, **factory)
        self.wk = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wv = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wo = nn.Linear(h * hd, d, bias=False, **factory)
        self.mlp_norm = nn.Parameter(torch.empty(d, **factory))
        self.w_gate = nn.Linear(d, f, bias=False, **factory)
        self.w_up = nn.Linear(d, f, bias=False, **factory)
        self.w_down = nn.Linear(f, d, bias=False, **factory)

    def mlp(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return swiglu(self, _rmsnorm(x, self.mlp_norm, eps))


def swiglu(lyr, y: torch.Tensor) -> torch.Tensor:
    """The MLP's product on its normed input ``y``, over the ffn width
    ``lyr`` holds (all of it, or one tensor shard's)."""
    return lyr.w_down(F.silu(lyr.w_gate(y)) * lyr.w_up(y))


class Llama(nn.Module):
    """The decoder's parameters: ``embed``, ``layers[i]``,
    ``final_norm``, ``lm_head``. Built on the meta device by default and
    filled by ``init_params`` or the bridge, so an 8B model never runs a
    throw-away initialisation."""

    def __init__(self, cfg: LlamaConfig, *, device="meta",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        factory = dict(device=device, dtype=dtype or cfg.torch_dtype)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **factory)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, **factory) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, **factory))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                 **factory)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.weight.dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def empty_model(cfg: LlamaConfig, device: Union[str, torch.device],
                dtype: Optional[torch.dtype] = None) -> Llama:
    """A Llama with uninitialised storage on ``device``, for inference
    (no parameter requires grad)."""
    model = Llama(cfg, dtype=dtype).to_empty(device=device)
    return model.requires_grad_(False)


def finish(model: Llama, trainable: bool) -> Llama:
    """A filled model, for inference (``.eval()``, no parameter requires
    grad) or, with ``trainable``, for training (every parameter requires
    grad, ``.train()``)."""
    model.requires_grad_(trainable)
    return model.train() if trainable else model.eval()


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device: Union[str, torch.device, None] = None,
                dtype: Optional[torch.dtype] = None, *,
                trainable: bool = False) -> Llama:
    """Random weights as ``ray_tpu.models.llama.init_params`` draws them:
    normal(0, 1) * fan_in^-0.5 in f32, cast to the model dtype; norms at
    one. ``device=None`` is the CUDA device, and raises when there is
    none; ``generator`` must live on the same kind of device. The numbers
    differ from jax.random's for the same seed. ``trainable=True`` gives
    a model for training (the numbers drawn are the same)."""
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
                            (lyr.wo, cfg.n_heads * cfg.head_dim),
                            (lyr.w_gate, d), (lyr.w_up, d),
                            (lyr.w_down, f)):
            # drawn in the JAX tree's (in, out) order, stored (out, in)
            lin.weight.copy_(draw(lin.weight.shape[::-1], fan_in).t())
    model.final_norm.fill_(1.0)
    model.lm_head.weight.copy_(draw((d, cfg.vocab_size), d).t())
    return finish(model, trainable)


# --- sharding over a mesh ------------------------------------------------------


def param_shardings(cfg: LlamaConfig, axes: MeshAxes = MeshAxes()) -> dict:
    """The JAX package's training layout (``ray_tpu/models/llama.py``
    ``param_shardings``: Megatron tensor sharding, FSDP on the other dim)
    over the port's tensors: per weight, one entry per dim naming the mesh
    axis that splits it (None: whole). ``nn.Linear`` stores (out, in), so
    JAX's ``P(None, fs, t)`` on an (in, out) weight reads ``(t, fs)`` here
    and ``P(None, t, fs)`` reads ``(fs, t)``; the layer axis JAX stacks
    does not exist. The norms are replicated."""
    t, fs = axes.tensor, axes.fsdp
    return {
        "embed": (t, fs),
        "layers": {
            "attn_norm": (None,),
            "wq": (t, fs),
            "wk": (t, fs),
            "wv": (t, fs),
            "wo": (fs, t),
            "mlp_norm": (None,),
            "w_gate": (t, fs),
            "w_up": (t, fs),
            "w_down": (fs, t),
        },
        "final_norm": (None,),
        "lm_head": (t, fs),
    }


def _spec_of(specs: dict, name: str) -> tuple:
    """The spec of a parameter by its ``named_parameters`` name."""
    path = name.split(".")
    if path[0] == "layers":
        return specs["layers"][path[2]]
    return specs[path[0]]


class _BlockLayer(nn.Module):
    """One layer's matrices at one (fsdp, tensor) block's shapes: the
    attention's, and the dense MLP's unless ``dense`` is False (the MoE
    family keeps its experts apart)."""

    def __init__(self, cfg: LlamaConfig, fsdp: int, tp: int,
                 dense: bool = True, **factory):
        super().__init__()
        d, hd = cfg.dim // fsdp, cfg.head_dim
        h, kvh, f = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.ffn_dim // tp
        self.wq = nn.Linear(d, h * hd, bias=False, **factory)
        self.wk = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wv = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wo = nn.Linear(h * hd, d, bias=False, **factory)
        if dense:
            self.w_gate = nn.Linear(d, f, bias=False, **factory)
            self.w_up = nn.Linear(d, f, bias=False, **factory)
            self.w_down = nn.Linear(f, d, bias=False, **factory)


class _Block(nn.Module):
    """One (fsdp, tensor) block of a ``Llama``'s matrices, under the same
    parameter names."""

    def __init__(self, cfg: LlamaConfig, fsdp: int, tp: int,
                 dense: bool = True, **factory):
        super().__init__()
        d, v = cfg.dim // fsdp, cfg.vocab_size // tp
        self.embed = nn.Embedding(v, d, **factory)
        self.layers = nn.ModuleList(
            _BlockLayer(cfg, fsdp, tp, dense, **factory)
            for _ in range(cfg.n_layers))
        self.lm_head = nn.Linear(d, v, bias=False, **factory)


class _NormLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.attn_norm = nn.Parameter(torch.empty(cfg.dim, **factory))
        self.mlp_norm = nn.Parameter(torch.empty(cfg.dim, **factory))


class _Norms(nn.Module):
    """A ``Llama``'s norms, under the same parameter names."""

    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.layers = nn.ModuleList(
            _NormLayer(cfg, **factory) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, **factory))


class MeshModule(nn.Module):
    """What the train step and the checkpoint plane read of a model
    family's module sharded over a mesh (``MeshLlama``; the MoE family's
    ``MeshMoE``): ``mesh`` and ``axes``; each parameter's place in the
    family's unsharded model (``layout``, ``entries``) and the whole
    tensors (``logical``). A subclass gives ``specs()`` (its
    ``param_shardings``), ``whole()`` (the unsharded model, on the meta
    device) and ``coords(scope, k)`` (the mesh coordinates of block k of
    a ``ModuleList`` named ``scope``); its ``norms`` scope holds whole
    tensors."""

    def specs(self) -> dict:
        raise NotImplementedError

    def whole(self) -> nn.Module:
        raise NotImplementedError

    def coords(self, scope: str, k: int) -> dict:
        raise NotImplementedError

    def layout(self) -> List[Tuple[str, tuple]]:
        """For each parameter, in ``parameters()`` order: the name it has
        in the unsharded model and the index of its block in that
        tensor."""
        specs = self.specs()
        out = []
        for full, p in self.named_parameters():
            scope, rest = full.split(".", 1)
            if scope == "norms":
                out.append((rest, ()))
                continue
            k, name = rest.split(".", 1)
            at = self.coords(scope, int(k))
            out.append((name, tuple(
                slice(None) if a is None
                else slice(at[a] * n, (at[a] + 1) * n)
                for a, n in zip(_spec_of(specs, name), p.shape))))
        return out

    def entries(self) -> List[Tuple[str, tuple, List[Tuple[int, tuple]]]]:
        """Each logical tensor, in the unsharded model's
        ``named_parameters()`` order: (name, its whole shape, [(index into
        ``parameters()``, the block's index in it)])."""
        parts: dict = {}
        for k, (name, idx) in enumerate(self.layout()):
            parts.setdefault(name, []).append((k, idx))
        return [(n, tuple(p.shape), parts[n])
                for n, p in self.whole().named_parameters()]

    @torch.no_grad()
    def logical(self, values: Optional[list] = None) -> dict:
        """{unsharded parameter name: the whole tensor} on the mesh's
        first device, assembled from ``values`` (aligned with
        ``parameters()``; default the parameters themselves, e.g. their
        grads or moments)."""
        values = list(self.parameters()) if values is None else values
        dev = self.mesh.devices[0]
        out = {}
        for name, shape, parts in self.entries():
            full = torch.empty(shape, dtype=values[parts[0][0]].dtype,
                               device=dev)
            for k, idx in parts:
                full[idx] = values[k].detach().to(dev)
            out[name] = full
        return out


class MeshLlama(MeshModule):
    """A ``Llama`` split over a ``DeviceMesh`` for training, per
    ``param_shardings``: ``blocks[f * tp + t]`` holds block (f, t) of every
    matrix, on the device of the first mesh shard with those fsdp and
    tensor coordinates; ``norms`` holds the replicated norms once, on the
    mesh's first device (a shard on another device reads them through
    ``.to()``, whose backward brings the gradient home, so there are no
    copies to keep equal and each norm is counted once)."""

    def __init__(self, cfg: LlamaConfig, mesh, axes: MeshAxes = MeshAxes(),
                 dtype: Optional[torch.dtype] = None, dense: bool = True):
        super().__init__()
        self.cfg, self.mesh, self.axes = cfg, mesh, axes
        self.fsdp, self.tp = mesh.shape[axes.fsdp], mesh.shape[axes.tensor]
        factory = dict(device="meta", dtype=dtype or cfg.torch_dtype)
        blocks = []
        for f in range(self.fsdp):
            for t in range(self.tp):
                home = mesh.devices[mesh.index({axes.fsdp: f,
                                                axes.tensor: t})]
                blocks.append(_Block(cfg, self.fsdp, self.tp, dense,
                                     **factory).to_empty(device=home))
        self.blocks = nn.ModuleList(blocks)
        self.norms = _Norms(cfg, **factory).to_empty(device=mesh.devices[0])

    def block(self, f: int, t: int) -> _Block:
        return self.blocks[f * self.tp + t]

    @property
    def dtype(self) -> torch.dtype:
        return self.norms.final_norm.dtype

    def specs(self) -> dict:
        return param_shardings(self.cfg, self.axes)

    def whole(self) -> nn.Module:
        return Llama(self.cfg)

    def coords(self, scope: str, k: int) -> dict:
        return {self.axes.fsdp: k // self.tp, self.axes.tensor: k % self.tp}


@torch.no_grad()
def shard_params_for_training(model: Llama, mesh,
                              axes: MeshAxes = MeshAxes(), *,
                              trainable: bool = True) -> MeshLlama:
    """``model`` cut per ``param_shardings`` over ``mesh``: each block a
    copy of its slice (never a view into ``model``), a leaf parameter
    requiring grad (``trainable``). Heads, kv heads (the contiguous head
    split of ``llm.model.shard_params_for_serving``), ffn and vocab must
    divide over the tensor axis, the width over fsdp."""
    cfg = model.cfg
    tp, fsdp = mesh.shape[axes.tensor], mesh.shape[axes.fsdp]
    for name, n, by, axis in (("n_heads", cfg.n_heads, tp, axes.tensor),
                              ("n_kv_heads", cfg.n_kv_heads, tp,
                               axes.tensor),
                              ("ffn_dim", cfg.ffn_dim, tp, axes.tensor),
                              ("vocab_size", cfg.vocab_size, tp,
                               axes.tensor),
                              ("dim", cfg.dim, fsdp, axes.fsdp)):
        if n % by:
            raise ValueError(f"{name}={n} not divisible by the mesh's "
                             f"{axis} size {by}")
    out = MeshLlama(cfg, mesh, axes, dtype=model.dtype)
    full = dict(model.named_parameters())
    for p, (name, idx) in zip(out.parameters(), out.layout()):
        p.copy_(full[name][idx])
    out.requires_grad_(trainable)
    return out.train() if trainable else out.eval()


# --- forward -----------------------------------------------------------------


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables (b, s, half) f32, computed once per forward."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[:, :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (b, s, h, d); cos/sin: (b, s, d//2) precomputed tables."""
    half = x.shape[-1] // 2
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _remat(cfg: LlamaConfig) -> Optional[dict]:
    """The ``checkpoint`` keywords of each layer's remat under the JAX
    package's policies (``ray_tpu/models/llama.py:262-280``), or None
    for no remat (``"none"`` or ``remat=False``):

    - ``"full"`` recomputes the whole layer on backward, K1 included;
    - ``"attn"`` saves attention's output and lse (the op
      ``ray_tpu_torch::flash_fwd_lse``: ``attn_out``/``attn_lse`` in
      the JAX package), so the backward never runs K1 again;
    - ``"dots"`` also saves every matmul without batch dims (JAX's
      ``checkpoint_dots_with_no_batch_dims``): the seven projections,
      which reach the dispatcher as ``aten.mm`` (``aten.addmm`` with a
      bias).

    The JAX package's ``attn_res`` name (the plain attention's output)
    has no counterpart: torch's recompute runs a layer's ops in order,
    so a saved plain-attention output would spare none of the plain
    attention's ops, whose outputs its backward needs anyway."""
    if not cfg.remat or cfg.remat_policy == "none":
        return None
    if cfg.remat_policy == "full":
        return {}
    import ray_tpu_torch.ops.attention  # noqa: F401  (registers the op)
    saved = [torch.ops.ray_tpu_torch.flash_fwd_lse.default]
    if cfg.remat_policy == "dots":
        saved += [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
    elif cfg.remat_policy != "attn":
        raise ValueError(f"unknown remat_policy: {cfg.remat_policy!r}")
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, saved)}


def _attn_block(lyr: nn.Module, x: torch.Tensor, rc: torch.Tensor,
                rs: torch.Tensor, cfg, impl: str) -> torch.Tensor:
    """The residual stream after a layer's attention half (``lyr`` holds
    ``attn_norm`` and ``wq/wk/wv/wo``; the MoE family's layers too)."""
    from ray_tpu_torch.ops.attention import attention
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
    q = _rope(lyr.wq(y).view(b, s, h, hd), rc, rs)
    k = _rope(lyr.wk(y).view(b, s, kvh, hd), rc, rs)
    v = lyr.wv(y).view(b, s, kvh, hd)
    o = attention(q, k, v, causal=True, impl=impl).to(x.dtype)
    return x + lyr.wo(o.reshape(b, s, h * hd))


def _layer(lyr: LlamaLayer, x: torch.Tensor, rc: torch.Tensor,
           rs: torch.Tensor, cfg: LlamaConfig, impl: str) -> torch.Tensor:
    x = _attn_block(lyr, x, rc, rs, cfg, impl)
    return x + lyr.mlp(x, cfg.norm_eps)


def forward_hidden(model: Llama, tokens: torch.Tensor,
                   cfg: Optional[LlamaConfig] = None, mesh=None,
                   axes: MeshAxes = MeshAxes()) -> torch.Tensor:
    """tokens: (batch, seq) int -> final normed hidden states
    (batch, seq, dim). Causal attention through ``ops.attention`` with
    ``cfg.attn_impl`` (without a mesh 'ring' is 'auto', as in the JAX
    package). ``cfg`` defaults to ``model.cfg``. With grad enabled, each
    layer is rematerialised per ``cfg.remat``/``cfg.remat_policy``. With
    a mesh of more than one device ``model`` is a ``MeshLlama`` on it, and
    the result is assembled on the mesh's first device."""
    cfg = model.cfg if cfg is None else cfg
    if _sharded(model, mesh):
        ps = _MeshPass(model, cfg)
        return ps.assemble(ps.hidden(ps.split({"tokens": tokens})["tokens"]))
    b, s = tokens.shape
    impl = "auto" if cfg.attn_impl == "ring" else cfg.attn_impl
    remat = _remat(cfg) if torch.is_grad_enabled() else None
    x = model.embed(tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    rc, rs = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for lyr in model.layers:
        if remat is not None:
            x = checkpoint(_layer, lyr, x, rc, rs, cfg, impl,
                           use_reentrant=False, **remat)
        else:
            x = _layer(lyr, x, rc, rs, cfg, impl)
    return _rmsnorm(x, model.final_norm, cfg.norm_eps)


def forward(model: Llama, tokens: torch.Tensor,
            cfg: Optional[LlamaConfig] = None, mesh=None,
            axes: MeshAxes = MeshAxes()) -> torch.Tensor:
    """tokens: (batch, seq) int -> logits (batch, seq, vocab) in
    ``cfg.logits_dtype`` (with a mesh, assembled on its first device)."""
    cfg = model.cfg if cfg is None else cfg
    dtype = getattr(torch, cfg.logits_dtype)
    if _sharded(model, mesh):
        ps = _MeshPass(model, cfg)
        hs = ps.hidden(ps.split({"tokens": tokens})["tokens"])
        lm = ps.lm_heads()
        return ps.assemble({ps.key[g[0]]: _group_logits(
            [hs[ps.key[j]] for j in g], [lm[j] for j in g],
            ps.devs[g[0]]).to(dtype) for g in ps.vocab_groups()})
    x = forward_hidden(model, tokens, cfg)
    return model.lm_head(x).to(dtype)


# --- loss --------------------------------------------------------------------


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood, f32: max/exp in the logits
    dtype, the sum and the final log in f32."""
    m = logits.max(dim=-1, keepdim=True).values
    sumexp = torch.exp(logits - m).sum(dim=-1, dtype=torch.float32)
    logz = m[..., 0].float() + torch.log(sumexp)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold.float()


def cross_entropy(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Masked token cross-entropy (mean over the mask, or over every
    token without one)."""
    nll = _nll(logits, batch["targets"])
    mask = batch.get("mask")
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _ce_chunk(x, lm_head, targets, mask, dtype):
    nll = _nll(lm_head(x).to(dtype), targets)
    return (nll * mask).sum(), mask.sum()


def fused_cross_entropy(x: torch.Tensor, lm_head: nn.Linear, batch: dict,
                        chunk: int, logits_dtype: str) -> torch.Tensor:
    """Chunked logits-free cross-entropy: each (b, chunk, dim) slice of
    the hidden states is projected to (b, chunk, vocab), reduced to the
    masked NLL sum and dropped; with grad, each chunk is checkpointed and
    recomputed on backward, so the live logits are one chunk's."""
    b, s, _ = x.shape
    dtype = getattr(torch, logits_dtype)
    targets = batch["targets"]
    mask = batch.get("mask")
    mask = (torch.ones((b, s), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        args = (x[:, i:i + chunk], lm_head, targets[:, i:i + chunk],
                mask[:, i:i + chunk], dtype)
        if torch.is_grad_enabled():
            t, c = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            t, c = _ce_chunk(*args)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)


def loss_fn(model: Llama, batch: dict,
            cfg: Optional[LlamaConfig] = None, mesh=None,
            axes: MeshAxes = MeshAxes()) -> torch.Tensor:
    """batch: {"tokens": (b, s), "targets": (b, s), "mask": optional}
    -> the scalar f32 loss. ``cfg`` defaults to ``model.cfg``. With a
    mesh of more than one device ``model`` is a ``MeshLlama`` on it and
    ``batch`` holds either the whole arrays or, per column, the list of
    every mesh shard's block (``shard_batch``); the loss is the global
    masked mean, on the mesh's first device."""
    cfg = model.cfg if cfg is None else cfg
    if _sharded(model, mesh):
        return _mesh_loss(_MeshPass(model, cfg), batch, cfg)
    s = batch["tokens"].shape[1]
    if cfg.ce_chunk > 0:
        if s % cfg.ce_chunk:
            # silently materializing the full logits here would undo
            # the exact memory saving the flag was set for
            raise ValueError(
                f"ce_chunk={cfg.ce_chunk} must divide seq len {s}")
        if s > cfg.ce_chunk:
            x = forward_hidden(model, batch["tokens"], cfg)
            return fused_cross_entropy(x, model.lm_head, batch,
                                       cfg.ce_chunk, cfg.logits_dtype)
        # s == ce_chunk: one chunk IS the full logits — classic path
    return cross_entropy(forward(model, batch["tokens"], cfg), batch)


# --- the forward over a mesh -------------------------------------------------


def _sharded(model, mesh) -> bool:
    """Whether a forward runs over a mesh: ``model`` is a ``MeshModule``
    (and ``mesh``, if given, is its mesh). A plain model with a mesh of
    one device is the single-device forward."""
    if isinstance(model, MeshModule):
        if mesh is not None and mesh is not model.mesh:
            raise ValueError("the model is sharded over another mesh")
        return True
    if mesh is not None and mesh.size > 1:
        raise TypeError("a mesh of more than one device needs the model "
                        "sharded over it (shard_params_for_training)")
    return False


def _block_of(n: int, parts: int, i: int, what: str, axis: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split over the mesh's "
                         f"{axis} size {parts}")
    m = n // parts
    return slice(i * m, (i + 1) * m)


def shard_index(mesh, axes: MeshAxes, j: int, shape) -> tuple:
    """The index of mesh shard j's block of a batch column of ``shape``:
    the rows split over (data, fsdp) (JAX's ``P(("data", "fsdp"), ...)``:
    data major), dim 1, the sequence, over context."""
    co = mesh.coords(j)
    fsdp = mesh.shape[axes.fsdp]
    rows = mesh.shape[axes.data] * fsdp
    idx = [_block_of(shape[0], rows, co[axes.data] * fsdp + co[axes.fsdp],
                     "a batch", f"{axes.data} x {axes.fsdp}")]
    if len(shape) > 1:
        idx.append(_block_of(shape[1], mesh.shape[axes.context],
                             co[axes.context], "a sequence", axes.context))
    return tuple(idx)


def shard_batch(batch: dict, mesh, axes: MeshAxes = MeshAxes(),
                move=None) -> dict:
    """{column: [every mesh shard's block, on the shard's device]} of a
    batch of whole arrays (tensors or host arrays), per ``shard_index``;
    shards with the same block on the same device share one tensor, put
    there by ``move(block, device)`` (default ``.to(device)``). A column
    given as a list is taken as the shards' blocks already."""
    move = move or (lambda x, dev: x.to(dev))
    out = {}
    for name, v in batch.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            if len(v) != mesh.size:
                raise ValueError(f"column {name!r} has {len(v)} blocks for "
                                 f"a mesh of {mesh.size} shards")
            out[name] = [torch.as_tensor(x).to(d)
                         for x, d in zip(v, mesh.devices)]
            continue
        x = torch.as_tensor(v)
        seen: dict = {}
        parts = []
        for j, dev in enumerate(mesh.devices):
            idx = shard_index(mesh, axes, j, x.shape)
            key = (tuple((i.start, i.stop) for i in idx), dev)
            if key not in seen:
                seen[key] = move(x[idx], dev)
            parts.append(seen[key])
        out[name] = parts
    return out


class _MeshPass:
    """The shards of one forward over ``model.mesh``. Shard j, at mesh
    coordinates (d, f, t, c, e), computes batch rows block r = d * fsdp +
    f and sequence block c on tensor slice t. The residual stream of (r, c)
    is the same on every tensor and expert shard, so it is kept, and its
    replicated work (norms, adds) done, once per distinct device among
    them (``key[j]`` = (r, c, device), ``lead``: the first shard of each
    key), as ``llm.model._Shards`` does for serving. The specs leave the
    expert axis out of everything but the MoE family's experts (JAX's
    ``P(batch, context, tensor)``): the embedding, attention and a dense
    MLP are replicated over it, and run once per (r, c, tensor slice,
    device) (``work[device]``: the first shard of each; ``twin[j]``: the
    one whose result shard j takes), and the loss reads each row block
    once (``vocab_groups``)."""

    def __init__(self, model: MeshLlama, cfg: LlamaConfig):
        self.model, self.cfg = model, cfg
        self.mesh, self.ax = model.mesh, model.axes
        self.fsdp, self.tp = model.fsdp, model.tp
        self.cp = self.mesh.shape[self.ax.context]
        self.ep = self.mesh.shape.get(self.ax.expert, 1)
        self.devs = self.mesh.devices
        self.co = [self.mesh.coords(j) for j in range(self.mesh.size)]
        self.key = [(c[self.ax.data] * self.fsdp + c[self.ax.fsdp],
                     c[self.ax.context], self.devs[j])
                    for j, c in enumerate(self.co)]
        self.lead: dict = {}
        self.on: dict = {}               # device -> its shards, in order
        self.work: dict = {}             # device -> its working shards
        self.twin: List[int] = []
        first: dict = {}
        for j, k in enumerate(self.key):
            self.lead.setdefault(k, j)
            self.on.setdefault(k[2], []).append(j)
            w = first.setdefault((k, self.co[j][self.ax.tensor]), j)
            self.twin.append(w)
            if w == j:
                self.work.setdefault(k[2], []).append(j)
        self.specs = param_shardings(cfg, self.ax)

    def split(self, batch: dict) -> dict:
        return shard_batch(batch, self.mesh, self.ax)

    def full(self, parts: dict) -> list:
        """Every shard's entry of ``parts`` (keyed by working shards): a
        shard that did not work takes its twin's."""
        return [parts[self.twin[j]] for j in range(self.mesh.size)]

    def vocab_groups(self) -> list:
        """The tensor groups (shards of one (r, c), in tensor order) at
        expert coordinate 0: each row block once."""
        return [g for g in self.mesh.groups(self.ax.tensor)
                if self.co[g[0]].get(self.ax.expert, 0) == 0]

    def weights(self, dev: torch.device, i: int, names) -> dict:
        """{(name, t): layer i's matrix ``name`` gathered over fsdp for
        tensor slice t, on ``dev``} for the slices of the shards there:
        the blocks' ``.to(dev)``, concatenated in fsdp order."""
        out = {}
        for name in names:
            dim = _spec_of(self.specs, f"layers.{i}.{name}").index(
                self.ax.fsdp)
            for t in sorted({self.co[j][self.ax.tensor]
                             for j in self.on[dev]}):
                parts = [getattr(self.model.block(f, t).layers[i],
                                 name).weight.to(dev)
                         for f in range(self.fsdp)]
                out[name, t] = (parts[0] if len(parts) == 1
                                else torch.cat(parts, dim))
        return out

    def lm_heads(self) -> list:
        """Every shard's lm_head block gathered over fsdp, on its device
        (one gather per tensor slice and device)."""
        dim = _spec_of(self.specs, "lm_head").index(self.ax.fsdp)
        done: dict = {}
        for j, c in enumerate(self.co):
            t, dev = c[self.ax.tensor], self.devs[j]
            if (t, dev) not in done:
                parts = [self.model.block(f, t).lm_head.weight.to(dev)
                         for f in range(self.fsdp)]
                done[t, dev] = (parts[0] if len(parts) == 1
                                else torch.cat(parts, dim))
        return [done[c[self.ax.tensor], self.devs[j]]
                for j, c in enumerate(self.co)]

    def norm(self, xs: dict, w: torch.Tensor, dev=None) -> dict:
        """``w``'s RMS norm of each key's stream (only ``dev``'s keys,
        when given)."""
        return {k: _rmsnorm(x, w.to(k[2]), self.cfg.norm_eps)
                for k, x in xs.items() if dev is None or k[2] == dev}

    def add(self, xs: dict, parts: dict) -> dict:
        """The residual stream plus the sum over tensor shards of a
        row-parallel product ({working shard: its partial}, or every
        shard's)."""
        red = self.mesh.all_reduce(self.full(parts), self.ax.tensor)
        return {k: xs[k] + red[j] for k, j in self.lead.items()}

    def per_device(self, remat, fn, *args) -> dict:
        """{shard: its output}, ``fn(self, dev, *args)`` giving those of
        the shards on ``dev``, run once per distinct device, each its own
        checkpoint region under ``remat``. A region never spans two
        devices: the autograd engine runs each device's backward on its
        own thread, and two threads must not start one region's
        recompute."""
        out = {}
        for dev in self.on:
            out.update(fn(self, dev, *args) if remat is None else
                       checkpoint(fn, self, dev, *args, use_reentrant=False,
                                  **remat))
        return out

    def embed(self, toks: list) -> dict:
        """Vocab-parallel lookup: each tensor shard looks up the tokens
        of its vocab block (zero rows for the others), its width blocks
        concatenated; the sum over tensor shards is the embedding (one
        nonzero term per token, so exact)."""
        vt = self.cfg.vocab_size // self.tp
        parts = {}
        for j in sorted(set(self.twin)):
            t, dev, tok = self.co[j][self.ax.tensor], self.devs[j], toks[j]
            idx = tok.long() - t * vt
            keep = (idx >= 0) & (idx < vt)
            idx = torch.where(keep, idx, torch.zeros_like(idx))
            rows = []
            for f in range(self.fsdp):
                w = self.model.block(f, t).embed.weight
                rows.append(F.embedding(idx.to(w.device), w).to(dev))
            x = rows[0] if len(rows) == 1 else torch.cat(rows, -1)
            parts[j] = x * keep[..., None].to(x.dtype)
        red = self.mesh.all_reduce(self.full(parts), self.ax.tensor)
        return {k: red[j] for k, j in self.lead.items()}

    def ropes(self, toks: list) -> dict:
        """RoPE tables per key at the global positions c * s_local + i."""
        tables: dict = {}
        out = {}
        for k, j in self.lead.items():
            _, c, dev = k
            b, s = toks[j].shape
            if (c, dev) not in tables:
                pos = c * s + torch.arange(s, dtype=torch.int32, device=dev)
                tables[(c, dev)] = _rope_tables(pos[None].expand(b, s),
                                                self.cfg.head_dim,
                                                self.cfg.rope_theta)
            out[k] = tables[(c, dev)]
        return out

    def layer(self, i: int, xs: dict, ropes: dict, remat) -> dict:
        """Layer i of the family over every shard (a Llama's)."""
        return _mesh_layer(self, i, xs, ropes, remat)

    def hidden(self, toks: list) -> dict:
        """The final normed hidden states, per key."""
        cfg = self.cfg
        remat = _remat(cfg) if torch.is_grad_enabled() else None
        xs = self.embed(toks)
        ropes = self.ropes(toks)
        for i in range(cfg.n_layers):
            xs = self.layer(i, xs, ropes, remat)
        return self.norm(xs, self.model.norms.final_norm)

    def assemble(self, blocks: dict) -> torch.Tensor:
        """Blocks keyed by (r, c, ...) -> the whole (b, s, ...) tensor on
        the mesh's first device."""
        by_rc = {k[:2]: v for k, v in blocks.items()}
        dev = self.devs[0]
        n_rows = self.mesh.shape[self.ax.data] * self.fsdp
        return torch.cat([torch.cat([by_rc[(r, c)].to(dev)
                                     for c in range(self.cp)], 1)
                          for r in range(n_rows)], 0)


def _mesh_attend(ps: _MeshPass, q: list, k: list, v: list) -> dict:
    """{working shard: its attention output}, from every shard's q, k
    and v, dispatched as the JAX package's ``_attend`` under a mesh: the
    ring over the context axis for 'ring', and for 'auto' when the
    context axis is split; else each shard's own causal attention
    ('auto'/'flash': the kernels on CUDA), or, with the sequence split,
    'reference' over the gathered keys and values."""
    from ray_tpu_torch.ops.attention import attention
    impl, cp = ps.cfg.attn_impl, ps.cp
    work = [j for j in range(ps.mesh.size) if ps.twin[j] == j]
    if impl == "ring" or (impl == "auto" and cp > 1):
        from ray_tpu_torch.ops.ring_attention import ring_attention
        out = ring_attention(q, k, v, ps.mesh, ps.ax.context)
        return {j: out[j] for j in work}
    if cp > 1:
        if impl != "reference":
            raise ValueError(
                f"attn_impl={impl!r} cannot run under a context-parallel "
                f"mesh (context axis size {cp}); use 'ring' or 'auto'")
        kg = ps.mesh.all_gather(k, ps.ax.context, 1)
        vg = ps.mesh.all_gather(v, ps.ax.context, 1)
        return {j: attention(q[j], kg[j], vg[j], causal=True, impl=impl,
                             q_offset=ps.co[j][ps.ax.context] * q[j].shape[1])
                for j in work}
    return {j: attention(q[j], k[j], v[j], causal=True, impl=impl)
            for j in work}


def _qkv_region(ps: _MeshPass, dev: torch.device, i: int, xs: dict,
                ropes: dict) -> dict:
    """{working shard on ``dev``: its (q, k, v)} of layer i, RoPE
    applied."""
    hd = ps.cfg.head_dim
    ys = ps.norm(xs, ps.model.norms.layers[i].attn_norm, dev)
    w = ps.weights(dev, i, ("wq", "wk", "wv"))
    out = {}
    for j in ps.work[dev]:
        key, t = ps.key[j], ps.co[j][ps.ax.tensor]
        y, (rc, rs) = ys[key], ropes[key]
        b, s, _ = y.shape
        out[j] = (_rope(F.linear(y, w["wq", t]).view(b, s, -1, hd), rc, rs),
                  _rope(F.linear(y, w["wk", t]).view(b, s, -1, hd), rc, rs),
                  F.linear(y, w["wv", t]).view(b, s, -1, hd))
    return out


def _wo_region(ps: _MeshPass, dev: torch.device, i: int, outs: dict,
               dtype: torch.dtype) -> dict:
    """{working shard on ``dev``: wo's partial product of its attention
    output}."""
    w = ps.weights(dev, i, ("wo",))
    return {j: F.linear(outs[j].to(dtype).flatten(2),
                        w["wo", ps.co[j][ps.ax.tensor]])
            for j in ps.work[dev]}


def _attn_region(ps: _MeshPass, dev: torch.device, i: int, xs: dict,
                 ropes: dict, dtype: torch.dtype) -> dict:
    """The attention block of ``dev``'s working shards when each attends
    over its own q, k and v (K1-K3 on the card): q, k, v, attention and
    wo's partial product, in one region."""
    from ray_tpu_torch.ops.attention import attention
    impl = ps.cfg.attn_impl
    outs = {j: attention(q, k, v, causal=True, impl=impl)
            for j, (q, k, v) in _qkv_region(ps, dev, i, xs, ropes).items()}
    return _wo_region(ps, dev, i, outs, dtype)


def _mlp_region(ps: _MeshPass, dev: torch.device, i: int,
                xs: dict) -> dict:
    """{working shard on ``dev``: w_down's partial product of its MLP}."""
    ys = ps.norm(xs, ps.model.norms.layers[i].mlp_norm, dev)
    w = ps.weights(dev, i, ("w_gate", "w_up", "w_down"))
    out = {}
    for j in ps.work[dev]:
        y, t = ys[ps.key[j]], ps.co[j][ps.ax.tensor]
        out[j] = F.linear(F.silu(F.linear(y, w["w_gate", t]))
                          * F.linear(y, w["w_up", t]), w["w_down", t])
    return out


def _mesh_attn(ps: _MeshPass, i: int, xs: dict, ropes: dict,
               remat) -> dict:
    """The residual stream after layer i's attention half, over every
    shard. Each block's per-device work is a remat region
    (``per_device``) holding that layer's fsdp gathers, so no gathered
    weight outlives it; wo's partials are summed over the tensor shards
    between regions, before the residual add. Attention that crosses
    shards (the ring, the gathered sequence) runs between the q/k/v and
    wo regions; the ring checkpoints its own steps."""
    dtype = next(iter(xs.values())).dtype
    if ps.cfg.attn_impl == "ring" or ps.cp > 1:
        qkv = ps.full(ps.per_device(remat, _qkv_region, i, xs, ropes))
        outs = _mesh_attend(ps, *([x[n] for x in qkv] for n in range(3)))
        parts = ps.per_device(remat, _wo_region, i, outs, dtype)
    else:
        parts = ps.per_device(remat, _attn_region, i, xs, ropes, dtype)
    return ps.add(xs, parts)


def _mesh_layer(ps: _MeshPass, i: int, xs: dict, ropes: dict,
                remat) -> dict:
    """Layer i of a Llama over every shard: the attention half, then the
    MLP's region, w_down's partials summed over the tensor shards before
    the residual add."""
    xs = _mesh_attn(ps, i, xs, ropes, remat)
    return ps.add(xs, ps.per_device(remat, _mlp_region, i, xs))


def _group_logits(xs: list, ws: list, dev: torch.device) -> torch.Tensor:
    """The logits of one tensor group's rows: each shard's hidden states
    ``xs`` against its lm_head block ``ws``, concatenated over the vocab
    in tensor order on ``dev`` (the group's first shard's)."""
    parts = [F.linear(x, w).to(dev) for x, w in zip(xs, ws)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _mesh_ce(xs: list, ws: list, targets: torch.Tensor, mask: torch.Tensor,
             dtype: torch.dtype):
    """The masked NLL sum and count of one tensor group's rows: its
    logits, then ``_nll`` as on one device."""
    nll = _nll(_group_logits(xs, ws, targets.device).to(dtype), targets)
    return (nll * mask).sum(), mask.sum()


def _mesh_loss(ps: _MeshPass, batch: dict, cfg: LlamaConfig) -> torch.Tensor:
    """The global masked mean: every tensor group's NLL sum and mask
    count, added on the mesh's first device in group order, then one
    division (JAX's ``tot / max(cnt, 1)`` over the whole batch). With
    ``ce_chunk`` each group's rows are cut in chunks of at most
    ``ce_chunk`` positions, each checkpointed (``fused_cross_entropy``)."""
    parts = ps.split(batch)
    toks = parts["tokens"]
    s = toks[0].shape[1] * ps.cp
    chunk = getattr(cfg, "ce_chunk", 0)     # the MoE family has none
    if chunk > 0 and s % chunk:
        raise ValueError(f"ce_chunk={chunk} must divide seq len {s}")
    fused = 0 < chunk < s
    hs = ps.hidden(toks)
    lm = ps.lm_heads()
    dtype = getattr(torch, cfg.logits_dtype)
    dev0 = ps.devs[0]
    tot = cnt = torch.zeros((), dtype=torch.float32, device=dev0)
    for g in ps.vocab_groups():
        targets = parts["targets"][g[0]]
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=targets.device) if "mask" not in parts
                else parts["mask"][g[0]].float())
        xs, ws = [hs[ps.key[j]] for j in g], [lm[j] for j in g]
        n = targets.shape[1]
        step = chunk if fused else n
        for a in range(0, n, step):
            args = ([x[:, a:a + step] for x in xs], ws,
                    targets[:, a:a + step], mask[:, a:a + step], dtype)
            if fused and torch.is_grad_enabled():
                t, c = checkpoint(_mesh_ce, *args, use_reentrant=False)
            else:
                t, c = _mesh_ce(*args)
            tot, cnt = tot + t.to(dev0), cnt + c.to(dev0)
    return tot / cnt.clamp_min(1.0)
