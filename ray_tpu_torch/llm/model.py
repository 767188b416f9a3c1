"""Cache-aware Llama forwards for inference: prefill, chunked prefill,
the single-token decode step over the paged pool or the monolithic slot
cache, and the speculative verify forward.

Counterpart of ``ray_tpu/llm/model.py`` on the port's ``Llama`` module.
PyTorch runs eagerly, so there is no jit and no per-shape compile: the
prompt buckets stay only because the paged engine's block arithmetic is
written over them. Where the JAX package donates a buffer to update it,
the port updates the tensor in place (``index_copy_``/``index_put_``)
and says so.

Tensor-parallel serving: ``shard_params_for_serving`` splits a ``Llama``
over a ``parallel.tp.TensorMesh`` in the JAX package's Megatron layout
(``serve_param_specs``), and every forward here takes the resulting
``ShardedLlama`` where it takes a ``Llama``. There is one transformer
body for both: each shard computes its heads and its slice of the ffn,
the mesh sums the two row-parallel products of each layer (wo's and
w_down's, GSPMD's two psums in the JAX package) and gathers the logits'
vocab shards, and the sampler runs once on the gathered logits. The KV
of a sharded forward is a list of per-shard tensors, split on the
kv-head dim.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import (Llama, LlamaConfig, _rmsnorm, _rope,
                                        _rope_tables, _spec_of, swiglu)


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


# --- tensor-parallel shards ---------------------------------------------------


def serve_param_specs(cfg: LlamaConfig, axis: str = "tensor") -> dict:
    """The Megatron tensor-parallel layout for inference, as the JAX
    package's ``serve_param_specs`` gives it, over the port's tensors: for
    each weight, one entry per dim, ``axis`` on the dim split over the
    mesh and None elsewhere (all None: replicated). ``nn.Linear`` stores
    (out, in), so the column-parallel projections (wq/wk/wv, w_gate/w_up,
    lm_head on the vocab) split dim 0 and the row-parallel ones (wo,
    w_down), whose partial products are summed over the mesh, dim 1. The
    embedding and the norms are replicated."""
    t = axis
    return {
        "embed": (None, None),
        "layers": {
            "attn_norm": (None,),
            "wq": (t, None),
            "wk": (t, None),
            "wv": (t, None),
            "wo": (None, t),
            "mlp_norm": (None,),
            "w_gate": (t, None),
            "w_up": (t, None),
            "w_down": (None, t),
        },
        "final_norm": (None,),
        "lm_head": (t, None),
    }


class _ShardLayer(nn.Module):
    """One layer's shard: ``LlamaLayer``'s parameters at 1/tp of the
    heads and of the ffn width, the norms whole."""

    def __init__(self, cfg: LlamaConfig, tp: int, **factory):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        h, kvh, f = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.ffn_dim // tp
        self.attn_norm = nn.Parameter(torch.empty(d, **factory))
        self.wq = nn.Linear(d, h * hd, bias=False, **factory)
        self.wk = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wv = nn.Linear(d, kvh * hd, bias=False, **factory)
        self.wo = nn.Linear(h * hd, d, bias=False, **factory)
        self.mlp_norm = nn.Parameter(torch.empty(d, **factory))
        self.w_gate = nn.Linear(d, f, bias=False, **factory)
        self.w_up = nn.Linear(d, f, bias=False, **factory)
        self.w_down = nn.Linear(f, d, bias=False, **factory)


class LlamaShard(nn.Module):
    """One tensor shard of a ``Llama``: the same parameter names, with
    the split weights at their per-shard shapes (``serve_param_specs``)
    and a whole copy of the replicated ones."""

    def __init__(self, cfg: LlamaConfig, tp: int, *, device="meta",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        factory = dict(device=device, dtype=dtype or cfg.torch_dtype)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **factory)
        self.layers = nn.ModuleList(
            _ShardLayer(cfg, tp, **factory) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, **factory))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size // tp, bias=False,
                                 **factory)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device


class ShardedLlama(nn.Module):
    """A ``Llama`` split over a ``TensorMesh``: ``shards[j]`` lives on
    ``mesh.devices[j]``. The forwards of this module take it where they
    take a ``Llama``; ``device`` is the first shard's, where the logits
    are gathered and sampled."""

    def __init__(self, cfg: LlamaConfig, shards, mesh):
        super().__init__()
        self.cfg = cfg
        self.shards = nn.ModuleList(shards)
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]


@torch.no_grad()
def shard_params_for_serving(model: Llama, mesh,
                             cfg: LlamaConfig) -> ShardedLlama:
    """``model`` split per ``serve_param_specs`` over ``mesh``: one
    ``LlamaShard`` per mesh device, each holding its own storage (a copy
    of its slice, never a view into the full weights). Validates the
    divisibility the layout needs: heads, kv heads, ffn and vocab all
    split over the mesh's axis."""
    axis = mesh.axis
    tp = mesh.shape[axis]
    for name, n in (("n_heads", cfg.n_heads),
                    ("n_kv_heads", cfg.n_kv_heads),
                    ("ffn_dim", cfg.ffn_dim),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(
                f"{name}={n} not divisible by tensor-parallel size {tp}")
    specs = serve_param_specs(cfg, axis)
    full = dict(model.named_parameters())
    shards = []
    for j, dev in enumerate(mesh.devices):
        shard = LlamaShard(cfg, tp, dtype=model.dtype).to_empty(device=dev)
        for name, p in shard.named_parameters():
            src = full[name]
            spec = _spec_of(specs, name)
            if axis in spec:
                dim = spec.index(axis)
                n = src.shape[dim] // tp
                src = src.narrow(dim, j * n, n)
            p.copy_(src)
        shards.append(shard.requires_grad_(False).eval())
    return ShardedLlama(cfg, shards, mesh)


class _Shards:
    """The shards one forward runs over and where they live. A ``Llama``
    is one shard with no reduction, so the single-device forward is the
    same op sequence as before meshes existed; a ``ShardedLlama`` runs
    each sharded op once per shard and each replicated one (the
    embedding, the norms, the RoPE tables, the residual stream) once per
    distinct device, on the first shard there. Shards on distinct
    devices each run the replicated ops, as GSPMD's replicas do; only
    where a device repeats (the one-card and CPU stand-in meshes) is the
    repeat skipped, so a stand-in's host time per step is a lower bound
    for the same tp over distinct cards."""

    def __init__(self, model):
        if isinstance(model, ShardedLlama):
            self.mods, self.mesh = list(model.shards), model.mesh
        else:
            self.mods, self.mesh = [model], None
        self.devs = [m.device for m in self.mods]
        self.lead: dict = {}            # device -> first shard index there
        for j, d in enumerate(self.devs):
            self.lead.setdefault(d, j)

    def __iter__(self):
        return iter(zip(self.mods, self.devs))

    def per_device(self, fn) -> dict:
        """{device: fn(device, the first shard module there)}."""
        return {d: fn(d, self.mods[j]) for d, j in self.lead.items()}

    def norm(self, xs: dict, i: int, name: str, eps: float) -> dict:
        """Layer i's replicated norm ``name`` of the residual stream."""
        return self.per_device(
            lambda d, m: _rmsnorm(xs[d], getattr(m.layers[i], name), eps))

    def add(self, xs: dict, parts) -> dict:
        """The residual stream plus the sum over shards of a row-parallel
        product: each shard's partial is reduced once, then added once
        per device."""
        red = parts if self.mesh is None else self.mesh.all_reduce(parts)
        return {d: xs[d] + red[j] for d, j in self.lead.items()}

    def gather(self, parts, dim: int) -> torch.Tensor:
        """The shards' parts concatenated in shard order, on the first
        shard's device."""
        return parts[0] if self.mesh is None else \
            self.mesh.all_gather(parts, dim)[0]

    def pack(self, parts):
        """Per-shard tensors as the caches hold them: a list under a mesh,
        the one tensor otherwise."""
        return list(parts) if self.mesh is not None else parts[0]


def split_kv_heads(x: torch.Tensor, mesh) -> list:
    """A full-head KV tensor (..., kvh, hd) cut on its kv-head dim over
    ``mesh``: shard j's slice, on mesh device j."""
    n = x.shape[-2] // mesh.size
    return [x[..., j * n:(j + 1) * n, :].to(d)
            for j, d in enumerate(mesh.devices)]


def parts(x) -> list:
    """The per-shard tensors of a cache entry (one, unsharded)."""
    return x if isinstance(x, list) else [x]


def map_parts(fn, x):
    """``fn`` applied to each shard's tensor of a cache entry, keeping its
    form (a list under a mesh, one tensor otherwise)."""
    return [fn(p) for p in x] if isinstance(x, list) else fn(x)


def kv_zeros(shape, dtype: torch.dtype, device, mesh=None):
    """A zeroed KV tensor of ``shape`` (..., kv_heads, head_dim) on
    ``device``; with ``mesh``, a list of one tensor per mesh device with
    the kv heads split over them."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    local = (*shape[:-2], shape[-2] // mesh.size, shape[-1])
    return [torch.zeros(local, dtype=dtype, device=d) for d in mesh.devices]


def init_cache(cfg: LlamaConfig, slots: int, max_len: int,
               dtype: torch.dtype, device, mesh=None) -> dict:
    """The monolithic slot cache: k/v (layers, slots, max_len, kvh, hd),
    zeroed, and ``length`` (slots,) int32, the cache position of each
    slot's next token. With ``mesh``, k/v are split on the kv-head dim:
    a list of (layers, slots, max_len, kvh/tp, hd) tensors, one on each
    mesh device, and ``length`` (replicated) lives on the first."""
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv_zeros(shape, dtype, device, mesh),
            "v": kv_zeros(shape, dtype, device, mesh),
            "length": torch.zeros((slots,), dtype=torch.int32,
                                  device=device if mesh is None
                                  else mesh.devices[0])}


def _qkv(y, lyr, cfg: LlamaConfig):
    """q, k, v (b, s, heads, hd) at the heads ``lyr`` holds (all of them,
    or one shard's)."""
    b, s = y.shape[:2]
    hd = cfg.head_dim
    return (lyr.wq(y).view(b, s, -1, hd), lyr.wk(y).view(b, s, -1, hd),
            lyr.wv(y).view(b, s, -1, hd))


def _gqa_attend_cached(q, cache_k, cache_v, lengths, cfg: LlamaConfig):
    """q: (b, h, hd) current-token queries; cache_k/v: (b, L, kvh, hd);
    lengths: (b,) valid cache entries per slot (incl. current token).
    The plain decode attention of the ``gather`` impl, at the heads given
    (all of them, or one shard's)."""
    b, h, hd = q.shape
    kvh = cache_k.shape[2]
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


def _layer_tail(par: _Shards, xs: dict, outs, i: int,
                cfg: LlamaConfig) -> dict:
    """The rest of layer i after attention: ``outs`` holds each shard's
    attention output (.., heads * hd). Adds wo's reduced product, then
    the MLP's (w_down's), each to the residual stream once."""
    xs = par.add(xs, [m.layers[i].wo(o.to(xs[d].dtype))
                      for (m, d), o in zip(par, outs)])
    ys = par.norm(xs, i, "mlp_norm", cfg.norm_eps)
    return par.add(xs, [swiglu(m.layers[i], ys[d]) for m, d in par])


def _logits(par: _Shards, xs: dict, cfg: LlamaConfig, pick) -> torch.Tensor:
    """f32 logits of the rows ``pick(x)`` selects from the final normed
    residual stream, gathered over the vocab shards."""
    ys = par.per_device(
        lambda d, m: _rmsnorm(xs[d], m.final_norm, cfg.norm_eps))
    return par.gather([m.lm_head(pick(ys[d])).float() for m, d in par], -1)


def _embed(par: _Shards, tokens: torch.Tensor) -> dict:
    return par.per_device(lambda d, m: m.embed(tokens.to(d).long()))


def _ropes(par: _Shards, positions: torch.Tensor, cfg: LlamaConfig) -> dict:
    return par.per_device(lambda d, m: _rope_tables(
        positions.to(d), cfg.head_dim, cfg.rope_theta))


@torch.no_grad()
def prefill(model: Llama, tokens: torch.Tensor, length: int,
            cfg: LlamaConfig, max_len: int) -> Tuple[torch.Tensor, dict]:
    """One padded prompt. tokens: (s,) int (padded to a bucket); length:
    actual prompt length. Returns (last-token logits (vocab,) f32,
    per-layer kv padded to max_len: k/v (layers, max_len, kvh, hd), per
    shard for a ``ShardedLlama``). Causal alone is exact: pad keys sit at
    positions >= length and every used query row is < length."""
    from ray_tpu_torch.ops.attention import attention
    s = tokens.shape[0]
    hd = cfg.head_dim
    par = _Shards(model)
    xs = _embed(par, tokens[None])                          # (1, s, dim)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    ropes = _ropes(par, positions[None], cfg)
    ks = [[] for _ in par.mods]
    vs = [[] for _ in par.mods]
    for i in range(cfg.n_layers):
        ys = par.norm(xs, i, "attn_norm", cfg.norm_eps)
        outs = []
        for j, (m, d) in enumerate(par):
            rc, rs = ropes[d]
            q, k, v = _qkv(ys[d], m.layers[i], cfg)
            q, k = _rope(q, rc, rs), _rope(k, rc, rs)
            o = attention(q, k, v, causal=True, sm_scale=hd ** -0.5,
                          impl=_serve_attn_impl(cfg))
            outs.append(o.reshape(1, s, -1))
            ks[j].append(k[0])
            vs[j].append(v[0])
        xs = _layer_tail(par, xs, outs, i, cfg)
    logits = _logits(par, xs, cfg, lambda x: x[0, length - 1])
    pad = (0, 0, 0, 0, 0, max_len - s)
    return logits, {"k": par.pack([F.pad(torch.stack(k), pad) for k in ks]),
                    "v": par.pack([F.pad(torch.stack(v), pad) for v in vs])}


@torch.no_grad()
def prefill_chunk(model: Llama, tokens: torch.Tensor, length: int,
                  offset: int, acc: dict,
                  cfg: LlamaConfig) -> Tuple[torch.Tensor, dict]:
    """One chunk of a long prompt: process ``tokens`` (one padded bucket)
    starting at absolute position ``offset``, attending to all earlier
    chunks' K/V in ``acc`` plus causally within the chunk. acc: {"k","v"}
    (layers, L, kvh, hd), per shard for a ``ShardedLlama``, updated IN
    PLACE with this chunk's KV (where the JAX package donates it).
    Returns (logits of the chunk's last valid token (vocab,) f32, acc).
    Positions beyond offset+length may hold pad garbage; every consumer
    masks by total length.

    Dispatch: on a flash-capable device the kernel runs with the chunk's
    absolute offset placing the causal diagonal; otherwise the
    dynamic-offset plain path runs."""
    L = parts(acc["k"])[0].shape[1]
    if offset + tokens.shape[0] > L:
        raise ValueError(
            f"chunk [{offset}, {offset + tokens.shape[0]}) overruns the "
            f"accumulator of length {L}")
    flash = flash_capable(cfg, tokens.device)
    return _prefill_chunk(model, tokens, int(length), int(offset), acc,
                          cfg, flash)


def zero_acc(cfg: LlamaConfig, length: int, dtype: torch.dtype,
             device, mesh=None) -> dict:
    """A zeroed chunked-prefill accumulator: k/v (layers, length, kvh,
    hd); with ``mesh``, one (layers, length, kvh/tp, hd) tensor per mesh
    device."""
    shape = (cfg.n_layers, length, cfg.n_kv_heads, cfg.head_dim)
    return {key: kv_zeros(shape, dtype, device, mesh) for key in ("k", "v")}


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
    dev = parts(acc["k"])[0].device
    while off < n:
        end = min(n, (off // chunk + 1) * chunk)
        part = tokens[off:end]
        padded = torch.tensor(pad_prompt(part, bucket_for(buckets,
                                                          len(part))),
                              device=dev)
        logits, acc = prefill_chunk(model, padded, len(part), off, acc, cfg)
        off = end
    return logits, acc


def _prefill_chunk(model: Llama, tokens, length: int, offset: int,
                   acc: dict, cfg: LlamaConfig, flash: bool):
    from ray_tpu_torch.ops.attention import attention
    s = tokens.shape[0]
    hd = cfg.head_dim
    par = _Shards(model)
    accs = list(zip(parts(acc["k"]), parts(acc["v"])))
    L = accs[0][0].shape[1]
    xs = _embed(par, tokens[None])                          # (1, s, dim)
    positions = offset + torch.arange(s, dtype=torch.int32,
                                      device=tokens.device)
    ropes = _ropes(par, positions[None], cfg)
    if not flash:
        # causal over absolute positions, limited to valid keys
        def mask(d, m):
            k_pos = torch.arange(L, dtype=torch.int32, device=d)
            p = positions.to(d)
            return ((k_pos[None, :] <= p[:, None])
                    & (k_pos[None, :] < offset + length))
        keeps = par.per_device(mask)
    for i in range(cfg.n_layers):
        ys = par.norm(xs, i, "attn_norm", cfg.norm_eps)
        outs = []
        for (m, d), (acc_k, acc_v) in zip(par, accs):
            ak, av = acc_k[i], acc_v[i]                     # (L, kvh, hd)
            rc, rs = ropes[d]
            q, k, v = _qkv(ys[d], m.layers[i], cfg)
            q, k = _rope(q, rc, rs), _rope(k, rc, rs)
            ak[offset:offset + s] = k[0].to(ak.dtype)
            av[offset:offset + s] = v[0].to(av.dtype)
            if flash:
                o = attention(q, ak[None].to(q.dtype), av[None].to(q.dtype),
                              causal=True, sm_scale=hd ** -0.5,
                              impl=_serve_attn_impl(cfg), q_offset=offset)
            else:
                kvh = ak.shape[1]
                qg = q[0].reshape(s, kvh, -1, hd).float()
                scores = torch.einsum("skgd,lkd->kgsl", qg,
                                      ak.float()) / math.sqrt(hd)
                scores = torch.where(keeps[d][None, None], scores,
                                     torch.full_like(scores, -1e30))
                probs = torch.softmax(scores, dim=-1)
                o = torch.einsum("kgsl,lkd->skgd", probs, av.float())
            outs.append(o.reshape(1, s, -1))
        xs = _layer_tail(par, xs, outs, i, cfg)
    return _logits(par, xs, cfg, lambda x: x[0, length - 1]), acc


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
    layout is abstracted by callables applied per layer i and shard:
    ``write(ck, cv, k, v)`` stores the new token's KV (k/v: (slots, kvh,
    hd)) into layer views ``ck = kcache[i]``, in place; ``view(ck, cv) ->
    (vk, vv)`` yields the (slots, L, kvh, hd) attention view. ``attend(q,
    ck, cv, positions) -> (slots, heads*hd) f32`` replaces view +
    _gqa_attend_cached when set (the paged kernel path). For a
    ``ShardedLlama`` the caches are per-shard lists and the hooks run
    once per shard on its heads (kvh and h read from the shapes), with
    ``positions`` on the shard's device. Returns the sampled tokens
    (slots,) int32, sampled once from the gathered logits."""
    b = tokens.shape[0]
    par = _Shards(model)
    caches = list(zip(parts(kcache), parts(vcache)))
    xs = _embed(par, tokens[:, None])                      # (b, 1, dim)
    ropes = _ropes(par, positions[:, None], cfg)
    pos = par.per_device(lambda d, m: positions.to(d))
    for i in range(cfg.n_layers):
        ys = par.norm(xs, i, "attn_norm", cfg.norm_eps)
        outs = []
        for (m, d), (kc, vc) in zip(par, caches):
            ck, cv = kc[i], vc[i]
            rc, rs = ropes[d]
            q, k, v = _qkv(ys[d], m.layers[i], cfg)        # (b, 1, ...)
            q, k = _rope(q, rc, rs), _rope(k, rc, rs)
            write(ck, cv, k[:, 0], v[:, 0])
            if attend is not None:
                o = attend(q[:, 0], ck, cv, pos[d])
            else:
                vk, vv = view(ck, cv)
                o = _gqa_attend_cached(q[:, 0], vk, vv, pos[d] + 1, cfg)
            outs.append(o.reshape(b, 1, -1))
        xs = _layer_tail(par, xs, outs, i, cfg)
    logits = _logits(par, xs, cfg, lambda x: x[:, 0])
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
    hd) and the (b, w) position grid, per shard as in
    ``decode_token_core``. Returns (b, w, vocab) f32 logits: row j is the
    distribution for position p+j+1, the verdict on draft token j+1. No
    device sampling: acceptance is a host decision (``llm/spec.py``)."""
    b, w = tokens.shape
    par = _Shards(model)
    caches = list(zip(parts(kcache), parts(vcache)))
    xs = _embed(par, tokens)                                # (b, w, dim)
    grid = positions[:, None] + torch.arange(
        w, dtype=positions.dtype, device=positions.device)[None]
    ropes = _ropes(par, grid, cfg)
    pos = par.per_device(lambda d, m: grid.to(d))
    for i in range(cfg.n_layers):
        ys = par.norm(xs, i, "attn_norm", cfg.norm_eps)
        outs = []
        for (m, d), (kc, vc) in zip(par, caches):
            ck, cv = kc[i], vc[i]
            rc, rs = ropes[d]
            q, k, v = _qkv(ys[d], m.layers[i], cfg)         # (b, w, ...)
            q, k = _rope(q, rc, rs), _rope(k, rc, rs)
            write(ck, cv, k, v)
            outs.append(attend(q, ck, cv, pos[d]).reshape(b, w, -1))
        xs = _layer_tail(par, xs, outs, i, cfg)
    return _logits(par, xs, cfg, lambda x: x)


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
    at = torch.clamp(positions, max=parts(cache["k"])[0].shape[2] - 1).long()

    def write(ck, cv, k, v):    # ck/cv: (slots, L, kvh, hd)
        idx = (rows.to(ck.device), at.to(ck.device))
        ck.index_put_(idx, k.to(ck.dtype))
        cv.index_put_(idx, v.to(cv.dtype))

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
    cache length, into ``slot`` in place, and set its length. A sharded
    cache takes per-shard KV."""
    for key in ("k", "v"):
        for c, x in zip(parts(cache[key]), parts(kv[key])):
            c[:, slot, :x.shape[1]] = x.to(c.dtype)
    cache["length"][slot] = int(length)
    return cache
