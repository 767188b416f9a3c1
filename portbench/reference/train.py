"""The reference's first training steps: from the weights the benchmark
drew and the batches the program was fed, the loss of each step, the
first gradient's norm per leaf as the optimizer gets it (clipped) and
each leaf's change over the steps, all in float32 arithmetic on state
held in the configuration's dtype (``reference/adamw.py``)."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench.reference import adamw
from portbench.reference.model import F32, Precision, loss_and_grads, no_tf32

Leaf = Tuple[str, object]


def leaf_norms(stacks: Dict[str, torch.Tensor], minus=None) -> Dict[Leaf, float]:
    """Per leaf (kind, layer or None): the float32 norm of the stack's
    slice, or of its difference with ``minus(kind)``'s."""
    out = {}
    for k, t in stacks.items():
        base = minus(k) if minus is not None else None
        rows = [None] if k in adamw.WHOLE else range(t.shape[0])
        for i in rows:
            x = t if i is None else t[i]
            if base is not None:
                x = x.float() - (base if i is None else base[i]).float()
            out[(k, i)] = float(torch.linalg.vector_norm(x, dtype=torch.float32))
        del base
    return out


def run_steps(W: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              m, opt: dict, draw_kind: Callable[[str], torch.Tensor],
              prec: Precision = F32) -> dict:
    """``len(batches)`` steps from ``W`` (updated in place). ``draw_kind``
    gives a kind's initial stack again, for the change."""
    no_tf32()
    mu = {k: torch.zeros_like(t) for k, t in W.items()}
    nu = {k: torch.zeros_like(t) for k, t in W.items()}
    losses: List[float] = []
    first: Dict[Leaf, float] = {}
    for n, (tok, tgt) in enumerate(batches):
        loss, grads, sq = loss_and_grads(W, tok, tgt, m, prec)
        gnorm = math.sqrt(sum(sq.values()))
        clip = adamw.step(W, mu, nu, grads, gnorm, n, opt)
        del grads
        if n == 0:
            first = {leaf: math.sqrt(v) * clip for leaf, v in sq.items()}
        losses.append(loss)
    del mu, nu
    change = leaf_norms(W, minus=draw_kind)
    return {"losses": losses, "first": first, "change": change}
