"""Plain PyTorch reference of the two configurations' decoders.

Mistral-7B (a Llama-style decoder: RMSNorm, rotate-half RoPE, grouped-
query causal attention, SwiGLU MLP, untied output head) and Mixtral-8x7B
(the same with a top-k mixture of SwiGLU experts in place of the MLP,
renormalised gates, per-row expert capacity filled choice by choice in
sequence order, and the Switch load-balancing loss), written from the
published architectures. It imports nothing of the program: it reads
the weight stacks the benchmark drew (``W``: kind -> tensor stacked over
layers, in the configuration's dtype) and computes in float32, with
TF32 off, layer by layer so that it fits beside nothing else on the
card.

Every product goes through a ``Precision``: ``F32`` computes as is; the
control (``reference/control.py``) rounds each operand to a lower
precision first, forward and backward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


class Precision:
    """Float32 products (the reference)."""
    name = "float32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x


F32 = Precision()


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _MM(torch.autograd.Function):
    """x (..., n) @ w (n, m) with both operands (and the incoming
    gradient) passed through the precision's rounding."""

    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(x, w)
        ctx.prec = prec
        return prec.q(x) @ prec.q(w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        p = ctx.prec
        dyq = p.q(dy)
        dx = dyq @ p.q(w).t()
        dw = p.q(x.reshape(-1, x.shape[-1])).t() @ dyq.reshape(-1, dy.shape[-1])
        return dx, dw, None


def mm(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _MM.apply(x, w, prec)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(n: int, hd: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, heads, hd); rotate-half over the two halves of hd."""
    h = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mask(s: int, device) -> torch.Tensor:
    i = torch.arange(s, device=device)
    return i[None, :] > i[:, None]          # True where a key is in the future


class _Attention(torch.autograd.Function):
    """Causal grouped-query attention, one (row, kv head) at a time so
    that the (s, s) scores of one group are all that lives at once; the
    backward recomputes them."""

    @staticmethod
    def forward(ctx, q, k, v, prec):
        o = attention_forward(q, k, v, prec)
        ctx.save_for_backward(q, k, v, o)
        ctx.prec = prec
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        p = ctx.prec
        b, s, h, hd = q.shape
        kvh = k.shape[2]
        g = h // kvh
        scale = hd ** -0.5
        masked = _mask(s, q.device)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for r in range(b):
            for j in range(kvh):
                qg = q[r, :, j * g:(j + 1) * g].transpose(0, 1)   # (g, s, hd)
                og = o[r, :, j * g:(j + 1) * g].transpose(0, 1)
                dog = do[r, :, j * g:(j + 1) * g].transpose(0, 1)
                kj, vj = k[r, :, j], v[r, :, j]                    # (s, hd)
                sc = (p.q(qg) @ p.q(kj).t()) * scale
                sc.masked_fill_(masked, float("-inf"))
                pr = torch.softmax(sc, dim=-1)
                dv[r, :, j] = (p.q(pr).transpose(1, 2) @ p.q(dog)).sum(0)
                dp = p.q(dog) @ p.q(vj).t()
                ds = pr * (dp - (dog * og).sum(-1, keepdim=True))
                dq[r, :, j * g:(j + 1) * g] = \
                    ((p.q(ds) @ p.q(kj)) * scale).transpose(0, 1)
                dk[r, :, j] = ((p.q(ds).transpose(1, 2) @ p.q(qg)) * scale).sum(0)
        return dq, dk, dv, None


def attention_forward(q, k, v, prec: Precision) -> torch.Tensor:
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    masked = _mask(s, q.device)
    o = torch.empty_like(q)
    for r in range(b):
        for j in range(kvh):
            qg = q[r, :, j * g:(j + 1) * g].transpose(0, 1)
            sc = (prec.q(qg) @ prec.q(k[r, :, j]).t()) * scale
            sc.masked_fill_(masked, float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            o[r, :, j * g:(j + 1) * g] = \
                (prec.q(pr) @ prec.q(v[r, :, j])).transpose(0, 1)
    return o


def attention(q, k, v, prec: Precision) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, prec)
    return attention_forward(q, k, v, prec)


def layer_weights(W: Dict[str, torch.Tensor], i: int, grad: bool) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s tensors in float32 (leaves that take gradients when
    ``grad``)."""
    out = {}
    for k, t in W.items():
        if k in ("embed", "final_norm", "lm_head"):
            continue
        w = t[i].to(torch.float32, copy=True)
        out[k] = w.requires_grad_() if grad else w
    return out


def _attn_half(x, w, m, cos, sin, prec):
    b, s, _ = x.shape
    hd = m.head_dim
    y = rmsnorm(x, w["attn_norm"], m.norm_eps)
    q = rope(mm(y, w["wq"].t(), prec).view(b, s, m.n_heads, hd), cos, sin)
    k = rope(mm(y, w["wk"].t(), prec).view(b, s, m.n_kv_heads, hd), cos, sin)
    v = mm(y, w["wv"].t(), prec).view(b, s, m.n_kv_heads, hd)
    o = attention(q, k, v, prec).reshape(b, s, m.n_heads * hd)
    return x + mm(o, w["wo"].t(), prec)


def route(y2: torch.Tensor, router: torch.Tensor, m, s: int, prec: Precision):
    """Top-k routing of one row's tokens y2 (s, d): the chosen experts
    (s, k), their renormalised gates (s, k), which choices fit their
    expert's capacity (s, k bool), and the router probabilities (s, E)."""
    E, k = m.n_experts, m.experts_per_token
    probs = torch.softmax(mm(y2, router, prec), dim=-1)
    order = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)
    idx = order.indices[:, :k]
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = m.capacity(s)
    used = torch.zeros(E, dtype=torch.long, device=y2.device)
    keep = torch.zeros_like(idx, dtype=torch.bool)
    for j in range(k):
        onehot = F.one_hot(idx[:, j], E)                     # (s, E)
        pos = (torch.cumsum(onehot, 0) - onehot + used)[
            torch.arange(s, device=y2.device), idx[:, j]]
        keep[:, j] = pos < cap
        used = used + (onehot * keep[:, j, None]).sum(0)
    return idx, gates, keep, probs


def _moe_half(x, w, m, prec):
    b, s, d = x.shape
    E, k = m.n_experts, m.experts_per_token
    y = rmsnorm(x, w["mlp_norm"], m.norm_eps)
    out_rows, f_e, p_e = [], 0.0, 0.0
    for r in range(b):
        idx, gates, keep, probs = route(y[r], w["router"], m, s, prec)
        out = torch.zeros_like(y[r])
        for e in range(E):
            tok, ch = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            ye = y[r][tok]
            h = F.silu(mm(ye, w["w_gate"][e], prec)) * mm(ye, w["w_up"][e], prec)
            out = out.index_add(0, tok, mm(h, w["w_down"][e], prec)
                                * gates[tok, ch][:, None])
        out_rows.append(out)
        f_e = f_e + F.one_hot(idx, E).float().sum(1).sum(0)
        p_e = p_e + probs.sum(0)
    n = b * s
    aux = E * torch.sum((f_e / n) * (p_e / n))
    return x + torch.stack(out_rows), aux


def layer(x, w, m, cos, sin, prec: Precision):
    """One decoder layer: (the residual stream after it, its aux loss)."""
    x = _attn_half(x, w, m, cos, sin, prec)
    if m.n_experts:
        return _moe_half(x, w, m, prec)
    y = rmsnorm(x, w["mlp_norm"], m.norm_eps)
    h = F.silu(mm(y, w["w_gate"].t(), prec)) * mm(y, w["w_up"].t(), prec)
    return x + mm(h, w["w_down"].t(), prec), x.new_zeros(())


HEAD_ROWS = 2048      # rows of logits alive at once


def _sq(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64)) ** 2


def loss_and_grads(W: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   targets: torch.Tensor, m, prec: Precision = F32):
    """The mean next-token cross-entropy (plus the weighted aux loss of
    an MoE) of ``tokens`` (b, s) and its gradient with respect to every
    leaf: (loss, {kind: gradients stacked like W, stored in W's dtype},
    {(kind, layer or None): the float32 gradient's squared norm}). The
    forward keeps each layer's input; the backward runs layer by layer
    from them, each layer's forward again under autograd."""
    b, s = tokens.shape
    dev = W["embed"].device
    cos, sin = rope_tables(s, m.head_dim, m.rope_theta, dev)
    inputs: List[torch.Tensor] = []
    aux = 0.0
    with torch.no_grad():
        x = W["embed"][tokens].float()
        for i in range(m.n_layers):
            inputs.append(x)
            x, a = layer(x, layer_weights(W, i, False), m, cos, sin, prec)
            aux = aux + float(a)
    xL = x.detach().requires_grad_()
    fn = W["final_norm"].to(torch.float32, copy=True).requires_grad_()
    head = W["lm_head"].to(torch.float32, copy=True).requires_grad_()
    flat_x = xL.reshape(-1, m.dim)
    flat_t = targets.reshape(-1).long()
    n = flat_t.numel()
    ce = 0.0
    for a in range(0, n, HEAD_ROWS):
        logits = mm(rmsnorm(flat_x[a:a + HEAD_ROWS], fn, m.norm_eps),
                    head.t(), prec)
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, flat_t[a:a + HEAD_ROWS, None])[:, 0]
        part = nll.sum() / n
        part.backward()
        ce += float(part.detach())
    grads, sq = {}, {}
    for k, t in (("final_norm", fn), ("lm_head", head)):
        sq[(k, None)] = _sq(t.grad)
        grads[k] = t.grad.to(W[k].dtype)
    del fn, head
    dx = xL.grad
    for i in reversed(range(m.n_layers)):
        xi = inputs[i].requires_grad_()
        w = layer_weights(W, i, True)
        out, a = layer(xi, w, m, cos, sin, prec)
        obj = (out * dx).sum() + m.aux_loss_weight * a
        obj.backward()
        dx = xi.grad
        inputs[i] = None
        for k, t in w.items():
            if k not in grads:
                grads[k] = torch.empty_like(W[k])
            sq[(k, i)] = _sq(t.grad)
            grads[k][i] = t.grad.to(W[k].dtype)
        del w, out, xi
    emb = torch.zeros(W["embed"].shape, dtype=torch.float32, device=dev)
    emb.index_add_(0, tokens.reshape(-1), dx.reshape(-1, m.dim))
    sq[("embed", None)] = _sq(emb)
    grads["embed"] = emb.to(W["embed"].dtype)
    return ce + m.aux_loss_weight * aux, grads, sq


@torch.no_grad()
def logits_at(W: Dict[str, torch.Tensor], tokens: torch.Tensor,
              rows: torch.Tensor, m, prec: Precision = F32) -> torch.Tensor:
    """The float32 logits (len(rows), vocab) at positions ``rows`` of the
    one sequence ``tokens`` (s,): the distribution of the token after
    each of those positions."""
    s = tokens.shape[0]
    cos, sin = rope_tables(s, m.head_dim, m.rope_theta, tokens.device)
    x = W["embed"][tokens[None]].float()
    for i in range(m.n_layers):
        x, _ = layer(x, layer_weights(W, i, False), m, cos, sin, prec)
    h = rmsnorm(x[0, rows], W["final_norm"].float(), m.norm_eps)
    return mm(h, W["lm_head"].float().t(), prec)
