"""Cache-aware Llama forwards for inference: prefill, chunked prefill,
the single-token decode step over the paged pool or the monolithic slot
cache, and the speculative verify forward.

Counterpart of ``ray_tpu/llm/model.py`` on the port's ``Llama`` module.
PyTorch runs eagerly, so there is no jit and no per-shape compile: the
prompt buckets stay only because the paged engine's block arithmetic is
written over them. Where the JAX package donates a buffer to update it,
the port updates the tensor in place (``index_copy_``/``index_put_``)
and says so.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (Llama, LlamaConfig, _rmsnorm, _rope,
                                        _rope_tables)


def bucket_for(buckets, n: int) -> int:
    """Smallest prefill shape bucket holding an n-token prompt."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_prompt(tokens, bucket: int) -> np.ndarray:
    """Zero-pad a prompt to its bucket (numpy, int32)."""
    out = np.zeros((bucket,), np.int32)
    out[:len(tokens)] = tokens
    return out


def init_cache(cfg: LlamaConfig, slots: int, max_len: int,
               dtype: torch.dtype, device, mesh=None) -> dict:
    """The monolithic slot cache: k/v (layers, slots, max_len, kvh, hd),
    zeroed, and ``length`` (slots,) int32, the cache position of each
    slot's next token."""
    if mesh is not None:
        raise NotImplementedError(
            "a cache sharded over a mesh (tensor-parallel serving) is not "
            "ported yet: ROADMAP Queue 1 item 11")
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((slots,), dtype=torch.int32,
                                  device=device)}


def _qkv(y, lyr, cfg: LlamaConfig):
    b, s = y.shape[:2]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (lyr.wq(y).view(b, s, h, hd), lyr.wk(y).view(b, s, kvh, hd),
            lyr.wv(y).view(b, s, kvh, hd))


def _gqa_attend_cached(q, cache_k, cache_v, lengths, cfg: LlamaConfig):
    """q: (b, h, hd) current-token queries; cache_k/v: (b, L, kvh, hd);
    lengths: (b,) valid cache entries per slot (incl. current token).
    The plain decode attention of the ``gather`` impl."""
    b = q.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, kvh, h // kvh, hd).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg,
                          cache_k.float()) / math.sqrt(hd)
    mask = (torch.arange(cache_k.shape[1], device=q.device)[None]
            < lengths[:, None])
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", probs, cache_v.float())
    return out.reshape(b, h * hd)


def _serve_attn_impl(cfg: LlamaConfig) -> str:
    """'ring' is a training-only layout: serving reads it as 'auto'."""
    impl = getattr(cfg, "attn_impl", "auto")
    return "auto" if impl == "ring" else impl


def flash_capable(cfg: LlamaConfig, device: torch.device) -> bool:
    """Whether prefill attention runs the flash kernel: an 'auto' or
    'flash' config on a CUDA device (on the CPU the plain version runs
    instead, and chunked prefill takes the dynamic-offset path)."""
    return (torch.device(device).type == "cuda"
            and _serve_attn_impl(cfg) in ("auto", "flash"))


def _layer_tail(x, o, lyr, cfg: LlamaConfig):
    x = x + lyr.wo(o.to(x.dtype))
    return x + lyr.mlp(x, cfg.norm_eps)


def _logits(model: Llama, x, length: int):
    x = _rmsnorm(x, model.final_norm, model.cfg.norm_eps)
    return model.lm_head(x[0, length - 1]).float()


@torch.no_grad()
def prefill(model: Llama, tokens: torch.Tensor, length: int,
            cfg: LlamaConfig, max_len: int) -> Tuple[torch.Tensor, dict]:
    """One padded prompt. tokens: (s,) int (padded to a bucket); length:
    actual prompt length. Returns (last-token logits (vocab,) f32,
    per-layer kv padded to max_len: k/v (layers, max_len, kvh, hd)).
    Causal alone is exact: pad keys sit at positions >= length and every
    used query row is < length."""
    from ray_tpu_torch.ops.attention import attention
    s = tokens.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    x = model.embed(tokens[None].long())                   # (1, s, dim)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    rc, rs = _rope_tables(positions[None], hd, cfg.rope_theta)
    ks, vs = [], []
    for lyr in model.layers:
        y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(y, lyr, cfg)
        q, k = _rope(q, rc, rs), _rope(k, rc, rs)
        o = attention(q, k, v, causal=True, sm_scale=hd ** -0.5,
                      impl=_serve_attn_impl(cfg))
        x = _layer_tail(x, o.reshape(1, s, h * hd), lyr, cfg)
        ks.append(k[0])
        vs.append(v[0])
    logits = _logits(model, x, length)
    pad = (0, 0, 0, 0, 0, max_len - s)
    return logits, {"k": F.pad(torch.stack(ks), pad),
                    "v": F.pad(torch.stack(vs), pad)}


@torch.no_grad()
def prefill_chunk(model: Llama, tokens: torch.Tensor, length: int,
                  offset: int, acc: dict,
                  cfg: LlamaConfig) -> Tuple[torch.Tensor, dict]:
    """One chunk of a long prompt: process ``tokens`` (one padded bucket)
    starting at absolute position ``offset``, attending to all earlier
    chunks' K/V in ``acc`` plus causally within the chunk. acc: {"k","v"}
    (layers, L, kvh, hd), updated IN PLACE with this chunk's KV (where
    the JAX package donates it). Returns (logits of the chunk's last valid
    token (vocab,) f32, acc). Positions beyond offset+length may hold pad
    garbage; every consumer masks by total length.

    Dispatch: on a flash-capable device the kernel runs with the chunk's
    absolute offset placing the causal diagonal; otherwise the
    dynamic-offset plain path runs."""
    if offset + tokens.shape[0] > acc["k"].shape[1]:
        raise ValueError(
            f"chunk [{offset}, {offset + tokens.shape[0]}) overruns the "
            f"accumulator of length {acc['k'].shape[1]}")
    flash = flash_capable(cfg, tokens.device)
    return _prefill_chunk(model, tokens, int(length), int(offset), acc,
                          cfg, flash)


def zero_acc(cfg: LlamaConfig, length: int, dtype: torch.dtype,
             device) -> dict:
    """A zeroed chunked-prefill accumulator: k/v (layers, length, kvh,
    hd)."""
    shape = (cfg.n_layers, length, cfg.n_kv_heads, cfg.head_dim)
    return {key: torch.zeros(shape, dtype=dtype, device=device)
            for key in ("k", "v")}


@torch.no_grad()
def chunked_prefill(model: Llama, tokens, buckets, acc: dict,
                    cfg: LlamaConfig, start: int = 0
                    ) -> Tuple[torch.Tensor, dict]:
    """A long prompt (or a prefix hit's suffix) through ``prefill_chunk``:
    ``tokens[start:]`` in pieces cut at multiples of the largest bucket
    (the chunk grid), each padded to its own bucket and attending to every
    earlier position of ``acc``, which is updated in place and must hold
    the last padded piece. Returns (the last token's logits (vocab,) f32,
    acc)."""
    chunk = buckets[-1]
    n = len(tokens)
    off = start
    logits = None
    while off < n:
        end = min(n, (off // chunk + 1) * chunk)
        part = tokens[off:end]
        padded = torch.tensor(pad_prompt(part, bucket_for(buckets,
                                                          len(part))),
                              device=acc["k"].device)
        logits, acc = prefill_chunk(model, padded, len(part), off, acc, cfg)
        off = end
    return logits, acc


def _prefill_chunk(model: Llama, tokens, length: int, offset: int,
                   acc: dict, cfg: LlamaConfig, flash: bool):
    from ray_tpu_torch.ops.attention import attention
    s = tokens.shape[0]
    L = acc["k"].shape[1]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kvh
    dev = tokens.device
    x = model.embed(tokens[None].long())                   # (1, s, dim)
    positions = offset + torch.arange(s, dtype=torch.int32, device=dev)
    rc, rs = _rope_tables(positions[None], hd, cfg.rope_theta)
    if not flash:
        # causal over absolute positions, limited to valid keys
        k_pos = torch.arange(L, dtype=torch.int32, device=dev)
        keep = ((k_pos[None, :] <= positions[:, None])
                & (k_pos[None, :] < offset + length))
    for i, lyr in enumerate(model.layers):
        ak, av = acc["k"][i], acc["v"][i]                  # (L, kvh, hd)
        y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(y, lyr, cfg)
        q, k = _rope(q, rc, rs), _rope(k, rc, rs)
        ak[offset:offset + s] = k[0].to(ak.dtype)
        av[offset:offset + s] = v[0].to(av.dtype)
        if flash:
            o = attention(q, ak[None].to(q.dtype), av[None].to(q.dtype),
                          causal=True, sm_scale=hd ** -0.5,
                          impl=_serve_attn_impl(cfg), q_offset=offset)
        else:
            qg = q[0].reshape(s, kvh, g, hd).float()
            scores = torch.einsum("skgd,lkd->kgsl", qg,
                                  ak.float()) / math.sqrt(hd)
            scores = torch.where(keep[None, None], scores,
                                 torch.full_like(scores, -1e30))
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("kgsl,lkd->skgd", probs, av.float())
        x = _layer_tail(x, o.reshape(1, s, h * hd), lyr, cfg)
    return _logits(model, x, length), acc


class _NUMPY_OPS:
    """The array ops ``filter_logits`` needs, on numpy (host) arrays."""

    @staticmethod
    def desc(x):
        return np.sort(x, axis=-1)[:, ::-1]

    @staticmethod
    def take(x, idx):
        return np.take_along_axis(x, idx, axis=1)

    @staticmethod
    def where(cond, a, b):
        return np.where(cond, a, b)

    @staticmethod
    def softmax(x):
        e = np.exp(x - np.max(x, axis=-1, keepdims=True))
        return e / np.sum(e, axis=-1, keepdims=True)

    @staticmethod
    def cumsum(x):
        return np.cumsum(x, axis=-1)

    @staticmethod
    def rowmin(x):
        return np.min(x, axis=-1)


class _TORCH_OPS:
    """The same ops on torch tensors (any device)."""

    @staticmethod
    def desc(x):
        return torch.sort(x, dim=-1, descending=True).values

    @staticmethod
    def take(x, idx):
        return torch.take_along_dim(x, idx.long(), dim=1)

    @staticmethod
    def where(cond, a, b):
        if not torch.is_tensor(a):
            a = torch.tensor(a, dtype=b.dtype, device=b.device)
        return torch.where(cond, a, b)

    @staticmethod
    def softmax(x):
        return torch.softmax(x, dim=-1)

    @staticmethod
    def cumsum(x):
        return torch.cumsum(x, dim=-1)

    @staticmethod
    def rowmin(x):
        return torch.amin(x, dim=-1)


def filter_logits(scaled, top_ks=None, top_ps=None):
    """The top-k -> top-p logits mask shared by the device sampler
    (``sample``) and host-side sampling: ONE implementation of the
    filter order, generic over torch tensors and numpy arrays. ``scaled``
    is logits already divided by temperature, (slots, vocab); top_ks
    (slots,) int with 0 disabling; top_ps (slots,) float in (0, 1] with
    1.0 disabling. Returns masked logits with filtered entries at -inf."""
    onp = isinstance(scaled, np.ndarray)
    xp = _NUMPY_OPS if onp else _TORCH_OPS
    v = scaled.shape[-1]
    masked = scaled
    if top_ks is not None:
        idx = (top_ks - 1).clip(0, v - 1)[:, None]
        kth = xp.take(xp.desc(scaled), idx)
        masked = xp.where((top_ks[:, None] > 0) & (scaled < kth),
                          -float("inf"), masked)
    if top_ps is not None:
        probs = xp.softmax(masked)
        sp = xp.desc(probs)
        cum = xp.cumsum(sp)
        # nucleus rule: keep the smallest prefix of the sorted probs whose
        # mass reaches p, i.e. tokens whose exclusive cumulative mass is
        # still < p (the top token always survives)
        keep = (cum - sp) < top_ps[:, None]
        thresh = xp.rowmin(xp.where(keep, sp, float("inf")))
        enabled = (top_ps < 1.0)[:, None]
        masked = xp.where(enabled & (probs < thresh[:, None]),
                          -float("inf"), masked)
    return masked


def sample(logits: torch.Tensor, temps: Optional[torch.Tensor],
           generator: Optional[torch.Generator],
           top_ps: Optional[torch.Tensor] = None,
           top_ks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling on the device: greedy where temp <= 0, else
    temperature -> top-k -> top-p -> categorical, drawn from the explicit
    ``generator``. ``temps=None`` means every slot is greedy: the caller
    decides that on the host, so the decode loop never waits on the
    device to branch. Returns (slots,) int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if temps is None:
        return greedy
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    masked = filter_logits(scaled, top_ks, top_ps)
    probs = torch.softmax(masked, dim=-1)
    drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temps <= 0, greedy, drawn.to(torch.int32))


@torch.no_grad()
def decode_token_core(model: Llama, kcache, vcache, tokens: torch.Tensor,
                      positions: torch.Tensor,
                      temps: Optional[torch.Tensor],
                      generator: Optional[torch.Generator],
                      cfg: LlamaConfig, write, view,
                      top_ps: Optional[torch.Tensor] = None,
                      top_ks: Optional[torch.Tensor] = None,
                      attend=None) -> torch.Tensor:
    """The decode-step transformer, one token for every slot. The cache
    layout is abstracted by callables applied per layer i: ``write(ck,
    cv, k, v)`` stores the new token's KV (k/v: (slots, kvh, hd)) into
    layer views ``ck = kcache[i]``, in place; ``view(ck, cv) -> (vk,
    vv)`` yields the (slots, L, kvh, hd) attention view. ``attend(q, ck,
    cv, positions) -> (slots, h*hd) f32`` replaces view +
    _gqa_attend_cached when set (the paged kernel path). Returns the
    sampled tokens (slots,) int32."""
    b = tokens.shape[0]
    x = model.embed(tokens[:, None].long())                # (b, 1, dim)
    rc, rs = _rope_tables(positions[:, None], cfg.head_dim, cfg.rope_theta)
    for i, lyr in enumerate(model.layers):
        ck, cv = kcache[i], vcache[i]
        y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(y, lyr, cfg)                        # (b, 1, ...)
        q, k = _rope(q, rc, rs), _rope(k, rc, rs)
        write(ck, cv, k[:, 0], v[:, 0])
        if attend is not None:
            o = attend(q[:, 0], ck, cv, positions)
        else:
            vk, vv = view(ck, cv)
            o = _gqa_attend_cached(q[:, 0], vk, vv, positions + 1, cfg)
        x = _layer_tail(x, o.reshape(b, 1, -1), lyr, cfg)
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = model.lm_head(x[:, 0]).float()
    return sample(logits, temps, generator, top_ps, top_ks)


@torch.no_grad()
def verify_tokens_core(model: Llama, kcache, vcache, tokens: torch.Tensor,
                       positions: torch.Tensor, cfg: LlamaConfig, write,
                       attend) -> torch.Tensor:
    """The speculative-verify transformer: decode_token_core widened from
    one token per slot to w, with its write and attend hooks.
    tokens: (b, w) int, column 0 the last emitted token and columns 1..w-1
    the draft; positions: (b,) cache position of column 0. All w KVs are
    written (position p+j for column j) in place; ``write(ck, cv, k, v)``
    takes (b, w, kvh, hd) slabs, ``attend(q, ck, cv, pos)`` q (b, w, h,
    hd) and the (b, w) position grid. Returns (b, w, vocab) f32 logits:
    row j is the distribution for position p+j+1, the verdict on draft
    token j+1. No device sampling: acceptance is a host decision
    (``llm/spec.py``)."""
    b, w = tokens.shape
    x = model.embed(tokens.long())                          # (b, w, dim)
    pos = positions[:, None] + torch.arange(
        w, dtype=positions.dtype, device=positions.device)[None]
    rc, rs = _rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for i, lyr in enumerate(model.layers):
        ck, cv = kcache[i], vcache[i]
        y = _rmsnorm(x, lyr.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(y, lyr, cfg)                         # (b, w, ...)
        q, k = _rope(q, rc, rs), _rope(k, rc, rs)
        write(ck, cv, k, v)
        o = attend(q, ck, cv, pos)
        x = _layer_tail(x, o.reshape(b, w, -1), lyr, cfg)
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    return model.lm_head(x).float()


def _decode_core(model: Llama, cache: dict, tokens: torch.Tensor,
                 temps: Optional[torch.Tensor],
                 generator: Optional[torch.Generator], cfg: LlamaConfig,
                 top_ps: Optional[torch.Tensor] = None,
                 top_ks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token for every slot against the monolithic cache: the new
    token's KV lands at each slot's ``length``, the slot cache is the
    attention view, and ``length`` advances by one, all in place (where
    the JAX package donates the cache). A slot past the cache (an empty
    slot whose length kept counting) writes its last position instead
    of off the end, as JAX drops such a write: both are garbage that no
    live request reads. Returns the sampled tokens (slots,) int32."""
    b = tokens.shape[0]
    positions = cache["length"]
    rows = torch.arange(b, device=tokens.device)
    at = torch.clamp(positions, max=cache["k"].shape[2] - 1).long()

    def write(ck, cv, k, v):    # ck/cv: (slots, L, kvh, hd)
        ck.index_put_((rows, at), k.to(ck.dtype))
        cv.index_put_((rows, at), v.to(cv.dtype))

    def view(ck, cv):
        return ck, cv

    out = decode_token_core(model, cache["k"], cache["v"], tokens,
                            positions, temps, generator, cfg, write, view,
                            top_ps, top_ks)
    cache["length"] += 1
    return out


@torch.no_grad()
def decode_step(model: Llama, cache: dict, tokens: torch.Tensor,
                temps: Optional[torch.Tensor],
                generator: Optional[torch.Generator],
                cfg: LlamaConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step for every slot; returns (tokens (slots,) int32,
    cache), the cache updated in place."""
    return _decode_core(model, cache, tokens, temps, generator, cfg), cache


@torch.no_grad()
def decode_steps(model: Llama, cache: dict, tokens: torch.Tensor,
                 temps: Optional[torch.Tensor],
                 generator: Optional[torch.Generator], cfg: LlamaConfig,
                 n: int, top_ps: Optional[torch.Tensor] = None,
                 top_ks: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """n chained decode steps as a loop on the device, each feeding its
    sampled tokens to the next with no host sync; ``temps=None`` samples
    greedily. Returns (tokens (n, slots) int32 on the device, cache); the
    caller syncs once when it copies the tokens. Slots whose request
    finishes mid-block produce discardable garbage."""
    outs = []
    toks = tokens
    for _ in range(n):
        toks = _decode_core(model, cache, toks, temps, generator, cfg,
                            top_ps, top_ks)
        outs.append(toks)
    return torch.stack(outs), cache


@torch.no_grad()
def write_prefill_to_cache(cache: dict, kv: dict, slot: int,
                           length: int) -> dict:
    """Install a prefilled request's KV (layers, n, kvh, hd), n <= the
    cache length, into ``slot`` in place, and set its length."""
    n = kv["k"].shape[1]
    for key in ("k", "v"):
        cache[key][:, slot, :n] = kv[key].to(cache[key].dtype)
    cache["length"][slot] = int(length)
    return cache
