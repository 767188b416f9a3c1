"""A configuration file read into the model description both sides use,
the weights drawn from the seed, and the program's model built on them.

The weights are drawn on the device in a few large calls: one
``torch.randn`` per kind of tensor, stacked over the layers, in the
dtype the model is served and trained in, each kind from a generator of
its own seeded by (--seed, kind), so that any kind can be drawn again
alone. The program's modules take views of these stacks as their
parameters; the reference draws the same stacks again after the
program's state is freed.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str                 # "dense" or "moe"
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    rope_theta: float
    norm_eps: float
    max_seq_len: int
    dtype: str = "bfloat16"
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 0.0
    aux_loss_weight: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def capacity(self, seq: int) -> int:
        """Slots per expert and row (the configuration's capacity rule)."""
        c = int(self.capacity_factor * self.experts_per_token * seq
                / self.n_experts)
        return max(4, -(-c // 4) * 4)


def itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def spec_from_config(cfg: dict) -> ModelSpec:
    """The model a configuration file describes (Hugging Face keys)."""
    moe = cfg["family"] == "moe"
    return ModelSpec(
        family=cfg["family"], vocab_size=int(cfg["vocab_size"]),
        dim=int(cfg["hidden_size"]), n_layers=int(cfg["num_hidden_layers"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]),
        ffn_dim=int(cfg["intermediate_size"]),
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        max_seq_len=int(cfg["max_position_embeddings"]),
        dtype=str(cfg["torch_dtype"]),
        n_experts=int(cfg["num_local_experts"]) if moe else 0,
        experts_per_token=int(cfg["num_experts_per_tok"]) if moe else 0,
        capacity_factor=float(cfg["assumed"]["capacity_factor"]) if moe
        else 0.0,
        aux_loss_weight=float(cfg["router_aux_loss_coef"]) if moe else 0.0)


def kinds(m: ModelSpec) -> Dict[str, Tuple[tuple, int, str]]:
    """Each kind of tensor: (stacked shape, fan-in (0: ones), dtype)."""
    d, f, V, L = m.dim, m.ffn_dim, m.vocab_size, m.n_layers
    q, kv = m.n_heads * m.head_dim, m.n_kv_heads * m.head_dim
    out = {"embed": ((V, d), d, m.dtype),
           "attn_norm": ((L, d), 0, m.dtype),
           "wq": ((L, q, d), d, m.dtype),
           "wk": ((L, kv, d), d, m.dtype),
           "wv": ((L, kv, d), d, m.dtype),
           "wo": ((L, d, q), q, m.dtype),
           "mlp_norm": ((L, d), 0, m.dtype)}
    if m.n_experts:
        E = m.n_experts
        out.update(router=((L, d, E), d, "float32"),
                   w_gate=((L, E, d, f), d, m.dtype),
                   w_up=((L, E, d, f), d, m.dtype),
                   w_down=((L, E, f, d), f, m.dtype))
    else:
        out.update(w_gate=((L, f, d), d, m.dtype),
                   w_up=((L, f, d), d, m.dtype),
                   w_down=((L, d, f), f, m.dtype))
    out.update(final_norm=((d,), 0, m.dtype), lm_head=((V, d), d, m.dtype))
    return out


def kind_seed(seed: int, kind: str) -> int:
    """The generator seed of one kind of tensor under run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64),
                                 zlib.crc32(kind.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def draw_kind(m: ModelSpec, seed: int, kind: str,
              device: torch.device) -> torch.Tensor:
    shape, fan_in, dtype = kinds(m)[kind]
    dt = getattr(torch, dtype)
    if fan_in == 0:
        return torch.ones(shape, dtype=dt, device=device)
    g = torch.Generator(device=device).manual_seed(kind_seed(seed, kind))
    t = torch.randn(shape, generator=g, dtype=dt, device=device)
    return t.mul_(fan_in ** -0.5)


def draw(m: ModelSpec, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every kind's stack, drawn from ``seed`` on ``device``."""
    return {k: draw_kind(m, seed, k, device) for k in kinds(m)}


def leaf_of(name: str) -> Tuple[str, Optional[int]]:
    """A module parameter's name -> (kind, layer or None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return parts[2], int(parts[1])
    return parts[0], None


def leaf_name(kind: str, layer: Optional[int]) -> str:
    return kind if layer is None else f"{kind}.{layer}"


def leaf_view(W: Dict[str, torch.Tensor], kind: str,
              layer: Optional[int]) -> torch.Tensor:
    return W[kind] if layer is None else W[kind][layer]


# --- the program's side ---------------------------------------------------


def port_config(m: ModelSpec, traffic: dict):
    """The port's config object for this model and job."""
    common = dict(vocab_size=m.vocab_size, dim=m.dim, n_layers=m.n_layers,
                  n_heads=m.n_heads, n_kv_heads=m.n_kv_heads,
                  ffn_dim=m.ffn_dim, max_seq_len=m.max_seq_len,
                  rope_theta=m.rope_theta, norm_eps=m.norm_eps,
                  dtype=m.dtype,
                  remat_policy=traffic.get("remat_policy", "full"),
                  logits_dtype=traffic.get("logits_dtype", "float32"))
    if m.n_experts:
        from ray_tpu_torch.models import moe
        return moe.MoEConfig(n_experts=m.n_experts,
                             experts_per_token=m.experts_per_token,
                             capacity_factor=m.capacity_factor,
                             aux_loss_weight=m.aux_loss_weight, **common)
    from ray_tpu_torch.models import llama
    return llama.LlamaConfig(ce_chunk=0, **common)


def family_module(m: ModelSpec):
    if m.n_experts:
        from ray_tpu_torch.models import moe
        return moe
    from ray_tpu_torch.models import llama
    return llama


def build_program_model(m: ModelSpec, pcfg, W: Dict[str, torch.Tensor],
                        trainable: bool):
    """The port's model module whose parameters are views of ``W``."""
    from torch import nn
    from ray_tpu_torch.models import llama
    fam = family_module(m)
    net = (fam.MoE if m.n_experts else fam.Llama)(pcfg, device="meta")
    for name, _ in list(net.named_parameters()):
        kind, layer = leaf_of(name)
        owner = net
        path = name.split(".")
        for p in path[:-1]:
            owner = owner[int(p)] if p.isdigit() else getattr(owner, p)
        setattr(owner, path[-1], nn.Parameter(leaf_view(W, kind, layer)))
    return llama.finish(net, trainable)
