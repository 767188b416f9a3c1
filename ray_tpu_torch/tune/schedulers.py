"""Trial schedulers: FIFO, ASHA early stopping, PBT exploit/explore.

Reference: python/ray/tune/schedulers/trial_scheduler.py (decision enum),
schedulers/async_hyperband.py (AsyncHyperBandScheduler._Bracket: rungs at
grace*eta^k; a trial reaching a rung below the top-1/eta quantile of that
rung's recorded results is stopped), schedulers/pbt.py
(PopulationBasedTraining: bottom-quantile trials clone a top trial's
checkpoint and continue with a perturbed config).

The port's copy of ``ray_tpu/tune/schedulers.py``, unchanged but for
import paths.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class Exploit:
    """Scheduler decision: stop this trial, restore the donor trial's
    latest checkpoint, continue with ``config``."""

    def __init__(self, donor_id: str, config: dict):
        self.donor_id = donor_id
        self.config = config


class FIFOScheduler:
    """No early stopping — every trial runs to completion."""

    def on_result(self, trial_id: str, metrics: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str, metrics: dict) -> None:
        pass


class _Rung:
    def __init__(self, milestone: float):
        self.milestone = milestone
        self.recorded: Dict[str, float] = {}

    def cutoff(self, frac: float, mode: str) -> Optional[float]:
        if not self.recorded:
            return None
        import numpy as np
        vals = list(self.recorded.values())
        q = (1 - frac) * 100 if mode == "max" else frac * 100
        return float(np.percentile(vals, q))


class ASHAScheduler:
    """Asynchronous successive halving (reference:
    schedulers/async_hyperband.py AsyncHyperBandScheduler)."""

    def __init__(self, *, metric: Optional[str] = None, mode: str = "min",
                 time_attr: str = "training_iteration",
                 max_t: float = 100, grace_period: float = 1,
                 reduction_factor: float = 4):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.rungs: List[_Rung] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(_Rung(t))
            t *= reduction_factor
        self.rungs.reverse()  # highest milestone first

    def on_result(self, trial_id: str, metrics: dict) -> str:
        t = metrics.get(self.time_attr)
        val = metrics.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP  # budget exhausted: finished, not culled
        decision = CONTINUE
        for rung in self.rungs:
            if t < rung.milestone or trial_id in rung.recorded:
                continue
            cut = rung.cutoff(1.0 / self.rf, self.mode)
            rung.recorded[trial_id] = float(val)
            if cut is not None:
                bad = (val < cut) if self.mode == "max" else (val > cut)
                if bad:
                    decision = STOP
            break  # only the highest applicable rung records
        return decision

    def on_trial_complete(self, trial_id: str, metrics: dict) -> None:
        pass


class PopulationBasedTraining:
    """PBT (reference: tune/schedulers/pbt.py PopulationBasedTraining).

    Every ``perturbation_interval`` steps of ``time_attr``, a trial in
    the bottom ``quantile_fraction`` of the population clones the
    checkpoint of a random top-quantile trial (exploit) and continues
    with a mutated config (explore): each hyperparameter in
    ``hyperparam_mutations`` is either resampled from its
    list/callable, or — for numeric values — multiplied by 0.8 or 1.2.
    Trainables must ``tune.report(..., checkpoint=...)`` periodically
    and restore from ``tune.get_checkpoint()`` at start.
    """

    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: float = 5,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        if not 0.0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self._last: Dict[str, float] = {}        # trial -> last perturb t
        self._score: Dict[str, float] = {}       # trial -> latest metric
        self._config: Dict[str, dict] = {}       # trial -> live config
        self.num_exploits = 0

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        self._config[trial_id] = dict(config)
        self._last.setdefault(trial_id, 0.0)

    def _quantiles(self):
        ranked = sorted(self._score,
                        key=lambda t: self._score[t],
                        reverse=(self.mode == "max"))
        n = max(1, int(len(ranked) * self.quantile))
        if len(ranked) < 2 * n:
            return [], []
        return ranked[:n], ranked[-n:]

    def _explore(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(spec):
                out[key] = spec()
                continue
            if isinstance(spec, (list, tuple)) and len(spec):
                # list specs stay IN the list: resample, or shift to an
                # adjacent candidate (reference pbt.py does the same)
                vals = list(spec)
                cur = out.get(key)
                if self.rng.random() < self.resample_p \
                        or cur not in vals:
                    out[key] = self.rng.choice(vals)
                else:
                    i = vals.index(cur) + self.rng.choice((-1, 1))
                    out[key] = vals[min(len(vals) - 1, max(0, i))]
                continue
            cur = out.get(key)
            if isinstance(cur, bool):
                continue
            if isinstance(cur, int):
                # ints can't collapse to 0 via the 0.8 multiply
                out[key] = max(1, round(cur * self.rng.choice((0.8, 1.2))))
            elif isinstance(cur, float):
                out[key] = cur * self.rng.choice((0.8, 1.2))
        return out

    def on_result(self, trial_id: str, metrics: dict):
        t = metrics.get(self.time_attr)
        val = metrics.get(self.metric)
        if t is None or val is None:
            return CONTINUE
        self._score[trial_id] = float(val)
        if t - self._last.get(trial_id, 0.0) < self.interval:
            return CONTINUE
        self._last[trial_id] = t
        top, bottom = self._quantiles()
        if trial_id not in bottom or not top:
            return CONTINUE
        donor = self.rng.choice(top)
        if donor == trial_id:
            return CONTINUE
        # bookkeeping (num_exploits, live config) moves to
        # on_exploit_applied: a trial can finish before the stop lands,
        # in which case the Tuner drops the decision on the floor
        return Exploit(donor, self._explore(self._config.get(donor, {})))

    def on_exploit_applied(self, trial_id: str, config: dict) -> None:
        """Called by the Tuner when the exploit restart actually
        happened (not merely decided)."""
        self._config[trial_id] = dict(config)
        self.num_exploits += 1

    def on_trial_complete(self, trial_id: str, metrics: dict) -> None:
        self._score.pop(trial_id, None)
