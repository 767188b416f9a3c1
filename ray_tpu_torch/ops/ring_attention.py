"""Ring attention: exact attention over a context-parallel mesh axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``. Each shard holds a
sequence block of q, k and v; the K/V blocks rotate around the ring of
the axis (``DeviceMesh.ring_shift``, JAX's ``ppermute`` to the next
position) while each shard folds the visiting block into an
online-softmax accumulator (o, m, l). Only the kv heads rotate: GQA heads
are expanded per chunk, after the shift. A chunk entirely in the future
of every local query is skipped (a Python test on the static offsets,
JAX's ``lax.cond``), and each computed step is checkpointed
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint(step)``), so the
backward keeps one step's (o, m, l) and recomputes its scores.

The per-chunk attention (JAX's ``_chunk_attn``) is plain jnp in the
reference, with no Pallas kernel, so it is plain PyTorch here on every
device. One process drives every shard, so the whole ring is one autograd
graph: the shift is a list rotation with ``.to()``, differentiated by
autograd with no hand-written backward.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.flash_attention import _repeat_kv

_NEG = -1e30


def _chunk_attn(q, k, v, q_off: int, k_off: int, causal: bool,
                scale: float):
    """One ring step: the local queries against one visiting KV block.

    q: (b, sq, h, d); k, v: (b, sk, kvh, d). Offsets are the global
    positions of element 0. Returns (o unnormalised f32 (b, sq, h, d),
    m (b, h, sq), l (b, h, sq))."""
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = q_off + torch.arange(sq, device=q.device)[:, None]
        cols = k_off + torch.arange(sk, device=q.device)[None, :]
        keep = (rows >= cols)[None, None]
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(keep, p, torch.zeros_like(p))  # exp(0) of masked rows
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def _step(q, k, v, o, m, l, q_off: int, k_off: int, causal: bool,
          scale: float):
    """Fold one visiting block into (o, m, l)."""
    oc, mc, lc = _chunk_attn(q, k, v, q_off, k_off, causal, scale)
    m_new = torch.maximum(m, mc)
    a1 = torch.exp(m - m_new)                          # (b, h, sq)
    a2 = torch.exp(mc - m_new)
    o = o * a1.transpose(1, 2)[..., None] + oc * a2.transpose(1, 2)[..., None]
    return o, m_new, l * a1 + lc * a2


def ring_attention(q_parts: List[torch.Tensor], k_parts: List[torch.Tensor],
                   v_parts: List[torch.Tensor], mesh, axis: str = "context",
                   causal: bool = True,
                   sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """Exact attention with the sequence split over ``axis`` of ``mesh``.

    ``*_parts``: one (b, s_local, heads, d) block per mesh shard, in the
    mesh's shard order, on the shard's device; position i along ``axis``
    holds sequence block i. Every group of shards along ``axis`` runs
    its own ring. Returns each shard's output block, in q's dtype."""
    n = mesh.shape[axis]
    pos = {j: i for g in mesh.groups(axis) for i, j in enumerate(g)}
    scale = (sm_scale if sm_scale is not None
             else q_parts[0].shape[-1] ** -0.5)
    grad = torch.is_grad_enabled()
    acc = []
    for q in q_parts:
        b, sq, h, _ = q.shape
        base = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
        acc.append((torch.zeros(q.shape, dtype=torch.float32,
                                device=q.device), base + _NEG, base))
    ks, vs = list(k_parts), list(v_parts)
    for t in range(n):
        for j, q in enumerate(q_parts):
            sq, sk = q.shape[1], ks[j].shape[1]
            q_off = pos[j] * sq
            k_off = ((pos[j] - t) % n) * sk  # whose block is visiting
            if causal and k_off > q_off + sq - 1:
                continue                     # in every local row's future
            args = (q, ks[j], vs[j], *acc[j], q_off, k_off, causal, scale)
            acc[j] = (checkpoint(_step, *args, use_reentrant=False) if grad
                      else _step(*args))
        if t < n - 1:
            ks = mesh.ring_shift(ks, axis)
            vs = mesh.ring_shift(vs, axis)
    out = []
    for q, (o, _, l) in zip(q_parts, acc):
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return out
