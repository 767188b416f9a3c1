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
``fused_cross_entropy`` (``ce_chunk > 0``) are the JAX package's. Meshes
are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

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


def _layer(lyr: LlamaLayer, x: torch.Tensor, rc: torch.Tensor,
           rs: torch.Tensor, cfg: LlamaConfig, impl: str) -> torch.Tensor:
    from ray_tpu_torch.ops.attention import attention
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
    q = _rope(lyr.wq(y).view(b, s, h, hd), rc, rs)
    k = _rope(lyr.wk(y).view(b, s, kvh, hd), rc, rs)
    v = lyr.wv(y).view(b, s, kvh, hd)
    o = attention(q, k, v, causal=True, impl=impl).to(x.dtype)
    x = x + lyr.wo(o.reshape(b, s, h * hd))
    return x + lyr.mlp(x, cfg.norm_eps)


def forward_hidden(model: Llama, tokens: torch.Tensor,
                   cfg: Optional[LlamaConfig] = None) -> torch.Tensor:
    """tokens: (batch, seq) int -> final normed hidden states
    (batch, seq, dim). Causal attention through ``ops.attention`` with
    ``cfg.attn_impl`` ('ring' is a training layout: 'auto' here).
    ``cfg`` defaults to ``model.cfg``. With grad enabled, each layer is
    rematerialised per ``cfg.remat``/``cfg.remat_policy``."""
    cfg = model.cfg if cfg is None else cfg
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
            cfg: Optional[LlamaConfig] = None) -> torch.Tensor:
    """tokens: (batch, seq) int -> logits (batch, seq, vocab) in
    ``cfg.logits_dtype``."""
    cfg = model.cfg if cfg is None else cfg
    x = forward_hidden(model, tokens, cfg)
    return model.lm_head(x).to(getattr(torch, cfg.logits_dtype))


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
            cfg: Optional[LlamaConfig] = None) -> torch.Tensor:
    """batch: {"tokens": (b, s), "targets": (b, s), "mask": optional}
    -> the scalar f32 loss. ``cfg`` defaults to ``model.cfg``."""
    cfg = model.cfg if cfg is None else cfg
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
