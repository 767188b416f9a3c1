"""Speculative decoding: prompt-lookup drafts and rejection-sampling
acceptance.

Counterpart of ``ray_tpu/llm/spec.py`` (speculative sampling, arxiv
2211.17192), copied so that the port never imports ``ray_tpu``. A
model-free drafter guesses up to k tokens, the engine scores all k+1
positions in one batched forward (``kvcache.paged_verify_steps``), and the
longest agreeing prefix is accepted, so a forward emits 1..k+1 tokens with
the output stream unchanged:

- at ``temperature <= 0`` acceptance is exact greedy match: a draft token
  survives iff it equals the model's argmax at its position, so the
  stream is token for token vanilla greedy decode's;
- at ``temperature > 0`` acceptance is rejection sampling against the
  model's temperature -> top-k -> top-p filtered distribution (the same
  ``filter_logits`` the device sampler runs): the drafter is a point
  mass, so draft d is accepted with probability p(d) and a rejection
  resamples from p with d zeroed and renormalised, which makes each
  emitted token an exact sample from p.

The drafter matches the longest suffix n-gram of the request's own
prompt+output history against that history and proposes the k tokens
that followed the match; an accept-rate window backs it off on low-hit
prompts so the verify overhead stays bounded. Drafting is host
bookkeeping only.

Rejected drafts need no device rollback: their KV lands beyond the
sequence's logical length, masked out of every attention and overwritten
by the next real write, and the host block accounting rolls back through
``KVBlockManager.truncate_seq``. The engine counts drafted, accepted and
rejected tokens into ``spec_metrics`` and keeps each request's totals on
the request, for its accept rate.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the drafter's default draft length (the JAX package's Config default),
# which sets the engine's verify-width buckets
DRAFT_K = 4


def spec_metrics() -> dict:
    """Get-or-create the speculative-decoding series (shared process
    registry, pushed to the head like every llm_* family). Catalog:

      llm_spec_accept_rate    drafted-token accept rate of the most
                              recently finished speculative request
      llm_spec_tokens_total   draft pipeline volume, tagged {kind}:
                              drafted | accepted | rejected
    """
    from ray_tpu_torch.util import metrics as m
    return {
        "accept_rate": m.Gauge(
            "llm_spec_accept_rate",
            "Draft-token accept rate of the most recently finished "
            "speculative request (accepted / drafted)"),
        "tokens": m.Counter(
            "llm_spec_tokens_total",
            "Speculative-decode token volume by kind (drafted = "
            "proposed by the drafter, accepted = survived verify, "
            "rejected = rolled back)",
            tag_keys=("kind",)),
    }


def width_buckets(k_max: int) -> Tuple[int, ...]:
    """Verify-width buckets for up to ``k_max`` draft tokens: widths pad
    up to 1+2^j, capped at k_max+1 (k_max=4 -> (2, 3, 5)), so the verify
    forward sees a bounded set of shapes however accepted lengths vary."""
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    out = set()
    j = 0
    while True:
        w = 1 + (1 << j)
        out.add(min(w, k_max + 1))
        if w >= k_max + 1:
            return tuple(sorted(out))
        j += 1


def bucket_width(buckets: Sequence[int], w: int) -> int:
    """Smallest verify bucket holding w in-flight tokens."""
    for b in buckets:
        if w <= b:
            return b
    return buckets[-1]


class PromptLookupDrafter:
    """Model-free n-gram drafter with accept-rate backoff. Stateless over
    the token history (the engine passes prompt+output each round);
    stateful over the accept window: the verdicts of the last ``window``
    drafted tokens, and when their accept rate drops below ``min_rate``
    the drafter goes quiet for an exponentially growing cooldown (probing
    again after it), so a low-hit request converges to vanilla decode
    cost."""

    def __init__(self, *, k: int = DRAFT_K, ngram_max: int = 3,
                 window: int = 16, min_rate: float = 0.25):
        self.k = int(k)
        self.ngram_max = int(ngram_max)
        self.window = int(window)
        self.min_rate = float(min_rate)
        self._recent: deque = deque(maxlen=self.window)
        self._cooldown = 0          # quiet rounds left before a probe
        self._backoff = 4           # next cooldown length (doubles)
        self.drafted = 0
        self.accepted = 0

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def propose(self, hist: Sequence[int],
                max_k: Optional[int] = None) -> List[int]:
        """Up to min(k, max_k) draft tokens continuing ``hist``: the
        longest suffix n-gram (ngram_max down to 1) matched against the
        history itself, preferring the latest match that still has a full
        k-token continuation (a match flush against the end of history
        predicts almost nothing). Returns [] when no n-gram matches or
        the drafter is cooling off."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return []
        k = self.k if max_k is None else min(self.k, int(max_k))
        if k < 1:
            return []
        hist = list(hist)
        n_hist = len(hist)
        for n in range(min(self.ngram_max, n_hist - 1), 0, -1):
            suf = hist[-n:]
            best = None
            for s in range(n_hist - n - 1, -1, -1):
                if hist[s:s + n] == suf:
                    if best is None:
                        best = s
                    if s + n + k <= n_hist:
                        best = s
                        break
            if best is not None:
                return hist[best + n:best + n + k]
        return []

    def record(self, n_drafted: int, n_accepted: int) -> None:
        """Feed one verify round's verdict back into the window."""
        self.drafted += n_drafted
        self.accepted += n_accepted
        for i in range(n_drafted):
            self._recent.append(1 if i < n_accepted else 0)
        if len(self._recent) < self.window:
            return
        rate = sum(self._recent) / len(self._recent)
        if rate < self.min_rate:
            self._cooldown = self._backoff
            self._backoff = min(self._backoff * 2, 64)
            self._recent.clear()
        else:
            self._backoff = 4


def host_probs(logits: np.ndarray, temperature: float, top_k: int,
               top_p: float) -> np.ndarray:
    """The model's sampling distribution for one position, on the host:
    temperature scale, ``filter_logits`` (the transform the device
    sampler runs) and softmax. Returns float64 probabilities summing
    to 1."""
    from ray_tpu_torch.llm.model import filter_logits
    scaled = (np.asarray(logits, np.float32)
              / max(float(temperature), 1e-6))[None]
    masked = filter_logits(
        scaled, np.asarray([top_k], np.int32),
        np.asarray([top_p], np.float32))[0].astype(np.float64)
    e = np.exp(masked - masked.max())
    return e / e.sum()


def accept_tokens(logits: np.ndarray, draft: Sequence[int], *,
                  temperature: float, top_k: int, top_p: float,
                  rng: np.random.Generator) -> Tuple[List[int], int]:
    """Judge one slot's verify round. ``logits``: (len(draft)+1, V) f32,
    row j the model's distribution for the position draft[j] sits at
    (row len(draft) is the bonus position). Returns (emitted tokens,
    n_accepted):

    - temperature <= 0: draft[j] survives while it equals argmax(row j);
      the emission is argmax(rows 0..n_accepted), vanilla greedy's
      stream.
    - temperature > 0: rejection sampling against p_j = host_probs(row
      j): draft d is accepted with probability p_j(d); on rejection the
      replacement is drawn from p_j with d zeroed and renormalised, and a
      fully accepted draft earns a bonus sample from the last row.

    Always emits at least one token; with an empty draft this is plain
    host sampling of row 0."""
    draft = [int(t) for t in draft]
    emitted: List[int] = []
    if temperature <= 0:
        targets = np.argmax(np.asarray(logits), axis=-1)
        n_acc = 0
        for j, d in enumerate(draft):
            if int(targets[j]) != d:
                break
            n_acc += 1
        emitted = [int(targets[j]) for j in range(n_acc + 1)]
        return emitted, n_acc
    n_acc = 0
    for j, d in enumerate(draft):
        p = host_probs(logits[j], temperature, top_k, top_p)
        if rng.random() < p[d]:
            n_acc += 1
            emitted.append(d)
            continue
        residual = p.copy()
        residual[d] = 0.0
        s = residual.sum()
        if s <= 0.0:        # p is a point mass on d: the rejection cannot
            emitted.append(d)       # happen in exact arithmetic; accept
            n_acc += 1
            continue
        residual /= s
        emitted.append(int(rng.choice(len(residual), p=residual)))
        return emitted, n_acc
    p = host_probs(logits[len(draft)], temperature, top_k, top_p)
    emitted.append(int(rng.choice(len(p), p=p)))
    return emitted, n_acc
