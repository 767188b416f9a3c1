"""Model FLOPs, frozen here as the yardstick of the utilisation metrics.

The convention is the one the port's model configs use for their
``flops_per_token`` (``LlamaConfig``, ``MoEConfig``): a trained token
costs 6 x the matmul parameters it touches (the embedding is a gather
and is not counted; an MoE layer counts its router and the top-k
experts' weights only) plus 12 * layers * dim * seq for attention's two
products over the whole sequence; rematerialised forwards are not
counted. A served token at context ``c`` (it attends ``c`` keys, itself
included) costs 2 x the same matmul parameters plus 4 * layers * dim * c.

Every function takes the harness's model description (``bench.model``'s
``ModelSpec`` or any object with the same fields), so nothing here
imports the program.
"""

from __future__ import annotations


def _attn_params(m) -> int:
    hd = m.head_dim
    return (m.dim * m.n_heads * hd + 2 * m.dim * m.n_kv_heads * hd
            + m.n_heads * hd * m.dim)


def matmul_params(m) -> int:
    """Parameters a token's matmuls touch: every layer's attention
    projections and MLP (for an MoE, its router and top-k experts), and
    the output head."""
    if m.n_experts:
        ffn = m.dim * m.n_experts + 3 * m.experts_per_token * m.dim * m.ffn_dim
    else:
        ffn = 3 * m.dim * m.ffn_dim
    return m.n_layers * (_attn_params(m) + ffn) + m.dim * m.vocab_size


def train_flops_per_token(m, seq: int) -> float:
    """Training FLOPs of one token of a ``seq``-token row."""
    return 6.0 * matmul_params(m) + 12.0 * m.n_layers * m.dim * seq


def forward_flops(m, context: int) -> float:
    """Forward FLOPs of one token that attends ``context`` keys."""
    return 2.0 * matmul_params(m) + 4.0 * m.n_layers * m.dim * context


def request_flops(m, prompt: int, generated: int) -> float:
    """Forward FLOPs of a served request: its ``prompt`` tokens at
    contexts 1..prompt, then each of its ``generated`` tokens but the
    last fed back at contexts prompt+1..prompt+generated-1 (the first
    generated token comes from the prompt's last position)."""
    fed = prompt + max(0, generated - 1)
    keys = fed * (fed + 1) // 2
    return 2.0 * matmul_params(m) * fed + 4.0 * m.n_layers * m.dim * keys
