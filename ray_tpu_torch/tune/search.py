"""Search spaces + variant generation.

Reference: python/ray/tune/search/sample.py (Domain/Float/Integer/
Categorical), search/basic_variant.py (BasicVariantGenerator: grid
cross-product x num_samples random draws).

The port's copy of ``ray_tpu/tune/search.py``, unchanged but for import
paths.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random):
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lo: float, hi: float, log: bool = False):
        self.lo, self.hi, self.log = lo, hi, log

    def sample(self, rng):
        if self.log:
            import math
            return math.exp(rng.uniform(math.log(self.lo),
                                        math.log(self.hi)))
        return rng.uniform(self.lo, self.hi)


class Integer(Domain):
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def sample(self, rng):
        return rng.randrange(self.lo, self.hi)


class Categorical(Domain):
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)


def uniform(lo: float, hi: float) -> Float:
    return Float(lo, hi)


def loguniform(lo: float, hi: float) -> Float:
    return Float(lo, hi, log=True)


def randint(lo: int, hi: int) -> Integer:
    """Inclusive lo, exclusive hi (reference: tune.randint)."""
    return Integer(lo, hi)


def choice(values: Sequence[Any]) -> Categorical:
    return Categorical(values)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    """Marker consumed by the variant generator: the cross product of all
    grid dimensions is exhausted (x num_samples)."""
    return {"grid_search": list(values)}


class Searcher:
    """Sequential suggestion ABC (reference: tune/search/searcher.py
    Searcher.suggest/on_trial_complete; concrete searchers there wrap
    Optuna/HyperOpt — here TPESearcher is native). A Searcher OBSERVES
    completed trials and proposes the next config; the Tuner drives it
    when TuneConfig.search_alg is set."""

    def set_search_properties(self, metric: Optional[str], mode: str,
                              param_space: Dict[str, Any]) -> None:
        self.metric = metric
        self.mode = mode
        self.param_space = dict(param_space)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          metrics: Dict[str, Any]) -> None:
        pass

    def observe(self, config: Dict[str, Any],
                metrics: Dict[str, Any]) -> None:
        """Feed a completed (config, metrics) observation WITHOUT a
        live trial id — how Tuner.restore replays finished trials into
        a model-based searcher so post-restore suggestions condition on
        the pre-interrupt results."""


class BasicVariantSearcher(Searcher):
    """generate_variants as a Searcher (grid x random, pre-expanded)."""

    def __init__(self, num_samples: int = 1, seed: Optional[int] = None):
        self.num_samples = num_samples
        self.seed = seed
        self._queue: Optional[List[dict]] = None

    def suggest(self, trial_id):
        if self._queue is None:
            self._queue = generate_variants(
                self.param_space, self.num_samples, self.seed)
        return self._queue.pop(0) if self._queue else None


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator (the algorithm behind
    HyperOpt, which the reference wraps — tune/search/hyperopt/):
    after ``n_initial`` random trials, completed observations split
    into a good set (best ``gamma`` fraction) and a bad set; candidates
    are drawn from a kernel density over the good configs and ranked by
    the density ratio l(x)/g(x). Supports Float (linear/log), Integer,
    and Categorical dims; fixed values pass through. grid_search
    markers belong to the basic variant generator, not a model-based
    searcher."""

    def __init__(self, n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._trials: Dict[str, Dict[str, Any]] = {}
        self._obs: List[tuple] = []    # (config, score)

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        if metric is None:
            raise ValueError("TPESearcher needs TuneConfig.metric")
        for k, v in param_space.items():
            if isinstance(v, dict) and "grid_search" in v:
                raise ValueError(
                    f"grid_search({k!r}) is incompatible with "
                    "TPESearcher; use BasicVariantSearcher")

    # -- observation ----------------------------------------------------

    def on_trial_complete(self, trial_id, metrics):
        cfg = self._trials.pop(trial_id, None)
        if cfg is None:
            return
        self.observe(cfg, metrics)

    def observe(self, config, metrics):
        if self.metric not in (metrics or {}):
            return
        score = float(metrics[self.metric])
        if self.mode == "max":
            score = -score
        self._obs.append((dict(config), score))

    # -- suggestion -----------------------------------------------------

    def suggest(self, trial_id):
        if len(self._obs) < self.n_initial:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._trials[trial_id] = cfg
        return dict(cfg)

    def _random_config(self) -> Dict[str, Any]:
        return {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self.param_space.items()}

    def _split(self):
        ranked = sorted(self._obs, key=lambda o: o[1])   # low = good
        n_good = max(1, int(self.gamma * len(ranked)))
        return ranked[:n_good], ranked[n_good:] or ranked[:n_good]

    @staticmethod
    def _to_unit(dom, v: float) -> float:
        import math
        if isinstance(dom, Float) and dom.log:
            return math.log(v)
        return float(v)

    @staticmethod
    def _from_unit(dom, u: float):
        import math
        if isinstance(dom, Float):
            v = math.exp(u) if dom.log else u
            return min(max(v, dom.lo), dom.hi)
        v = int(round(u))
        return min(max(v, dom.lo), dom.hi - 1)

    def _tpe_config(self) -> Dict[str, Any]:
        import math
        good, bad = self._split()
        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand: Dict[str, Any] = {}
            llr = 0.0     # sum of log density ratios l(x)/g(x)
            anchor = self._rng.choice(good)[0]
            for k, dom in self.param_space.items():
                if not isinstance(dom, Domain):
                    cand[k] = dom
                    continue
                gv = [c[k] for c, _ in good]
                bv = [c[k] for c, _ in bad]
                if isinstance(dom, Categorical):
                    # draw from smoothed good histogram; ratio of
                    # smoothed frequencies
                    weights = [gv.count(val) + 1.0 for val in dom.values]
                    total = sum(weights)
                    r = self._rng.uniform(0, total)
                    acc = 0.0
                    val = dom.values[-1]
                    for x, w in zip(dom.values, weights):
                        acc += w
                        if r <= acc:
                            val = x
                            break
                    lg = (gv.count(val) + 1.0) / (len(gv) + len(dom.values))
                    bg = (bv.count(val) + 1.0) / (len(bv) + len(dom.values))
                    cand[k] = val
                    llr += math.log(lg / bg)
                else:
                    gu = [self._to_unit(dom, v) for v in gv]
                    bu = [self._to_unit(dom, v) for v in bv]
                    mean = sum(gu) / len(gu)
                    var = sum((x - mean) ** 2 for x in gu) / len(gu)
                    lo = self._to_unit(dom, dom.lo)
                    hi = self._to_unit(dom, dom.hi if isinstance(dom, Float)
                                       else dom.hi - 1)
                    span = max(hi - lo, 1e-12)
                    bw = max(math.sqrt(var), span * 0.1 /
                             max(len(gu), 1) ** 0.5, 1e-12)
                    # perturb the anchor's value (Parzen sample)
                    u = self._to_unit(dom, anchor[k]) \
                        + self._rng.gauss(0.0, bw)
                    u = min(max(u, lo), hi)

                    def dens(pts, x, h):
                        return sum(
                            math.exp(-0.5 * ((x - p) / h) ** 2) / h
                            for p in pts) / len(pts) + 1e-12

                    llr += math.log(dens(gu, u, bw) /
                                    dens(bu, u, max(bw, span * 0.2)))
                    cand[k] = self._from_unit(dom, u)
            if llr > best_score:
                best_score, best_cfg = llr, cand
        return best_cfg


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Expand grid dimensions to their cross product; draw every sampled
    Domain independently per variant (reference: basic_variant.py)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, dict) and "grid_search" in v]
    grid_values = [param_space[k]["grid_search"] for k in grid_keys]
    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    out: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in combos:
            cfg = {}
            for k, v in param_space.items():
                if k in grid_keys:
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            out.append(cfg)
    return out
