"""Distributed gradient-boosted decision trees: histogram-merge over
the object plane.

The XGBoostTrainer analog (reference:
python/ray/train/xgboost/xgboost_trainer.py — which wraps xgboost's own
collective tracker). xgboost isn't vendored here, so this is a NATIVE
histogram GBDT with the same distribution strategy xgboost itself uses
(approx/hist algorithm): each worker holds a row shard, computes
per-(node, feature, bin) gradient/hessian histograms locally, and the
driver SUMS histograms across workers — an exact-sum allreduce, so the
distributed model matches single-worker training on the concatenated
data up to float64 summation order (shard-partial sums reassociate
additions; a near-tie split gain could in principle resolve
differently). Rows never move after sharding; only (nodes x features x
bins) histograms cross the object plane per tree level.

Supported: squared-error regression and logistic binary classification,
quantile-binned features (<=256 bins -> uint8 storage), depth-wise tree
growth with L2 leaf regularization + min-child-weight, per-round
validation metrics, train.Checkpoint export, vectorized predict.

The port's copy of ``ray_tpu/train/boosting.py``, unchanged but for
import paths: numpy on the host, no device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch

MAX_BINS = 256


# --- loss ----------------------------------------------------------------

def _grad_hess(objective: str, margin: np.ndarray, y: np.ndarray):
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-margin))
        return p - y, np.maximum(p * (1.0 - p), 1e-16)
    # reg:squarederror
    return margin - y, np.ones_like(margin)


def _metric(objective: str, margin: np.ndarray, y: np.ndarray) -> float:
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-margin))
        p = np.clip(p, 1e-7, 1 - 1e-7)
        return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())
    return float(((margin - y) ** 2).mean())


# --- trees ---------------------------------------------------------------

@dataclass
class _Tree:
    """Flat arrays, breadth-first layout; node i's children are 2i+1 /
    2i+2. feature == -1 marks a leaf."""
    feature: np.ndarray     # (n_nodes,) int32
    threshold: np.ndarray   # (n_nodes,) int32  (bin index; go left if <=)
    value: np.ndarray       # (n_nodes,) float64 leaf weight

    def apply_binned(self, xb: np.ndarray) -> np.ndarray:
        """xb: (n, F) uint8 binned features -> (n,) leaf values."""
        idx = np.zeros(len(xb), np.int64)
        for _ in range(32):                       # depth bound
            feat = self.feature[idx]
            live = feat >= 0
            if not live.any():
                break
            go_left = np.zeros(len(xb), bool)
            go_left[live] = xb[np.nonzero(live)[0], feat[live]] <= \
                self.threshold[idx[live]]
            idx = np.where(live,
                           2 * idx + np.where(go_left, 1, 2), idx)
        return self.value[idx]


def _grow_tree(hist_fn, depth: int, lam: float, min_child_weight: float,
               n_features: int, n_bins: np.ndarray,
               feature: np.ndarray, threshold: np.ndarray,
               value: np.ndarray) -> _Tree:
    """Level-wise growth from merged histograms. `hist_fn(level)` must
    return (G, H): (n_nodes_at_level, F, MAX_BINS) summed across all
    workers for the CURRENT node assignment. The split arrays are
    caller-ALLOCATED and mutated in place level by level — hist_fn
    ships them to the workers so each level's row routing sees the
    splits this function just decided."""
    for level in range(depth):
        start = 2 ** level - 1
        count = 2 ** level
        G, H = hist_fn(level)                     # (count, F, B)
        for j in range(count):
            node = start + j
            if level > 0 and feature[(node - 1) // 2] < 0:
                continue                          # parent became a leaf
            g_tot = G[j, 0].sum()
            h_tot = H[j, 0].sum()
            if h_tot < 2 * min_child_weight:
                # empty node (no rows reach it): 0/0 with reg_lambda=0
                # would silently seed NaN into every prediction
                value[node] = -g_tot / (h_tot + lam) if h_tot > 0 else 0.0
                continue
            parent_score = g_tot * g_tot / (h_tot + lam)
            best_gain, best_f, best_t = 1e-12, -1, -1
            for f in range(n_features):
                gl = np.cumsum(G[j, f])
                hl = np.cumsum(H[j, f])
                # split candidates: bin b -> left is bins [0, b]
                gr = g_tot - gl
                hr = h_tot - hl
                ok = (hl >= min_child_weight) & (hr >= min_child_weight)
                gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) \
                    - parent_score
                gain = np.where(ok, gain, -np.inf)
                b = int(np.argmax(gain[:n_bins[f] - 1])) \
                    if n_bins[f] > 1 else 0
                if n_bins[f] > 1 and gain[b] > best_gain:
                    best_gain, best_f, best_t = float(gain[b]), f, b
            if best_f < 0:
                value[node] = -g_tot / (h_tot + lam) if h_tot > 0 else 0.0
            else:
                feature[node] = best_f
                threshold[node] = best_t
        if not (feature[start:start + count] >= 0).any():
            # nothing split at this level: every frontier node already
            # got its leaf value above, and hist_fn must NOT be called
            # for deeper levels (workers route rows one level per call)
            return _Tree(feature, threshold, value)
    # last level: leaves for every node whose parent split
    start = 2 ** depth - 1
    G, H = hist_fn(depth)
    for j in range(2 ** depth):
        node = start + j
        if feature[(node - 1) // 2] < 0:
            continue
        g_tot = G[j, 0].sum()
        h_tot = H[j, 0].sum()
        # empty frontier nodes get 0.0, not 0/0 (see the level loop)
        value[node] = -g_tot / (h_tot + lam) if h_tot > 0 else 0.0
    return _Tree(feature, threshold, value)


# --- worker actor --------------------------------------------------------

class _BoostWorker:
    """Holds one row shard binned to uint8; computes level histograms
    and maintains this shard's margin as trees arrive."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 bin_edges: List[np.ndarray], objective: str,
                 base_score: float):
        self.y = np.asarray(y, np.float64)
        self.objective = objective
        X = np.asarray(X)
        self.n, self.F = X.shape
        self.xb = np.empty((self.n, self.F), np.uint8)
        for f in range(self.F):
            self.xb[:, f] = np.searchsorted(
                bin_edges[f], X[:, f], side="left")
        self.margin = np.full(self.n, base_score, np.float64)
        self.node = np.zeros(self.n, np.int64)     # frontier assignment
        self.grad = self.hess = None

    def start_round(self) -> bool:
        self.node[:] = 0
        self.grad, self.hess = _grad_hess(
            self.objective, self.margin, self.y)
        return True

    def level_hist(self, level: int, tree_feature, tree_threshold):
        """Apply the previous level's splits to the node assignment,
        then histogram this level's frontier. Returns (G, H) float64
        (2^level, F, MAX_BINS)."""
        if level > 0:
            feat = np.asarray(tree_feature)
            thr = np.asarray(tree_threshold)
            live = feat[self.node] >= 0
            rows = np.nonzero(live)[0]
            f = feat[self.node[rows]]
            go_left = self.xb[rows, f] <= thr[self.node[rows]]
            self.node[rows] = 2 * self.node[rows] + \
                np.where(go_left, 1, 2)
        count = 2 ** level
        start = count - 1
        G = np.zeros((count, self.F, MAX_BINS))
        H = np.zeros((count, self.F, MAX_BINS))
        local = self.node - start
        live = (self.node >= start) & (self.node < start + count)
        rows = np.nonzero(live)[0]
        for f in range(self.F):
            flat = local[rows] * MAX_BINS + self.xb[rows, f]
            # assign (never `+=` through a reshape: a non-contiguous
            # slice reshapes to a COPY and the update silently vanishes)
            G[:, f, :] = np.bincount(
                flat, weights=self.grad[rows],
                minlength=count * MAX_BINS).reshape(count, MAX_BINS)
            H[:, f, :] = np.bincount(
                flat, weights=self.hess[rows],
                minlength=count * MAX_BINS).reshape(count, MAX_BINS)
        return G, H

    def finish_round(self, feature, threshold, value, lr: float):
        tree = _Tree(np.asarray(feature), np.asarray(threshold),
                     np.asarray(value))
        self.margin += lr * tree.apply_binned(self.xb)
        return _metric(self.objective, self.margin, self.y), self.n


# --- trainer -------------------------------------------------------------

@dataclass
class BoostingConfig:
    objective: str = "reg:squarederror"   # or "binary:logistic"
    num_boost_round: int = 50
    max_depth: int = 4
    learning_rate: float = 0.3
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    max_bins: int = MAX_BINS
    num_workers: int = 2
    worker_options: dict = field(default_factory=dict)


class BoostingResult:
    def __init__(self, model: "BoostingModel",
                 metrics_history: List[dict]):
        self.model = model
        self.metrics_history = metrics_history
        self.metrics = metrics_history[-1] if metrics_history else {}


class BoostingModel:
    """The trained ensemble; self-contained for predict/save."""

    def __init__(self, trees: List[_Tree], bin_edges: List[np.ndarray],
                 objective: str, base_score: float, lr: float):
        self.trees = trees
        self.bin_edges = bin_edges
        self.objective = objective
        self.base_score = base_score
        self.lr = lr

    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        xb = np.empty(X.shape, np.uint8)
        for f in range(X.shape[1]):
            xb[:, f] = np.searchsorted(
                self.bin_edges[f], X[:, f], side="left")
        out = np.full(len(X), self.base_score, np.float64)
        for t in self.trees:
            out += self.lr * t.apply_binned(xb)
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        m = self.predict_margin(X)
        if self.objective == "binary:logistic":
            return 1.0 / (1.0 + np.exp(-m))
        return m

    def to_state(self) -> dict:
        return {"trees": [(t.feature, t.threshold, t.value)
                          for t in self.trees],
                "bin_edges": self.bin_edges,
                "objective": self.objective,
                "base_score": self.base_score, "lr": self.lr}

    @classmethod
    def from_state(cls, st: dict) -> "BoostingModel":
        return cls([_Tree(*t) for t in st["trees"]], st["bin_edges"],
                   st["objective"], st["base_score"], st["lr"])


def _make_bins(X: np.ndarray, max_bins: int) -> List[np.ndarray]:
    """Global quantile bin edges per feature (xgboost 'hist' sketch —
    exact quantiles here; the bins, not the rows, are what every worker
    must agree on)."""
    edges = []
    qs = np.linspace(0, 1, max_bins)[1:-1]
    for f in range(X.shape[1]):
        e = np.unique(np.quantile(X[:, f], qs))
        edges.append(e.astype(np.float64))
    return edges


class BoostingTrainer:
    """Distributed GBDT: rows sharded across worker actors, histograms
    merged driver-side per tree level. The model equals single-worker
    training on the concatenated data (up to float summation order in
    the histogram merge)."""

    def __init__(self, config: BoostingConfig,
                 train_set: Tuple[np.ndarray, np.ndarray],
                 valid_set: Optional[Tuple[np.ndarray, np.ndarray]]
                 = None):
        self.cfg = config
        self.X, self.y = (np.asarray(train_set[0], np.float64),
                          np.asarray(train_set[1], np.float64))
        self.valid = valid_set

    def fit(self) -> BoostingResult:
        cfg = self.cfg
        if not 2 <= cfg.max_bins <= MAX_BINS:
            # bins live in uint8 storage and histograms stride by
            # MAX_BINS — beyond that the model silently trains on
            # wrapped bin ids
            raise ValueError(
                f"max_bins must be in [2, {MAX_BINS}], got "
                f"{cfg.max_bins}")
        n, F = self.X.shape
        bin_edges = _make_bins(self.X, cfg.max_bins)
        n_bins = np.array([len(e) + 1 for e in bin_edges], np.int64)
        base = (float(self.y.mean()) if cfg.objective ==
                "reg:squarederror" else 0.0)
        W = max(1, cfg.num_workers)
        Worker = ray_tpu_torch.remote(_BoostWorker)
        shards = np.array_split(np.arange(n), W)
        workers = [
            Worker.options(**cfg.worker_options).remote(
                self.X[s], self.y[s], bin_edges, cfg.objective, base)
            for s in shards if len(s)]

        trees: List[_Tree] = []
        history: List[dict] = []
        # validation state kept INCREMENTALLY (bin once, add each new
        # tree's contribution) — re-predicting the growing ensemble per
        # round would be O(rounds^2) tree applications
        if self.valid is not None:
            Xv = np.asarray(self.valid[0], np.float64)
            yv = np.asarray(self.valid[1], np.float64)
            xb_v = np.empty(Xv.shape, np.uint8)
            for f in range(Xv.shape[1]):
                xb_v[:, f] = np.searchsorted(
                    bin_edges[f], Xv[:, f], side="left")
            valid_margin = np.full(len(Xv), base, np.float64)
        for rnd in range(cfg.num_boost_round):
            ray_tpu_torch.get([w.start_round.remote() for w in workers],
                              timeout=300)
            n_nodes = 2 ** (cfg.max_depth + 1) - 1
            tree_feature = np.full(n_nodes, -1, np.int32)
            tree_threshold = np.zeros(n_nodes, np.int32)
            tree_value = np.zeros(n_nodes, np.float64)

            def hist_fn(level):
                # the histogram-MERGE: each worker's (nodes, F, bins)
                # grad/hess tensors summed on the driver — an exact
                # allreduce over the object plane. The in-progress
                # split arrays ride along so workers route their rows
                # down the levels grown so far.
                parts = ray_tpu_torch.get(
                    [w.level_hist.remote(level, tree_feature,
                                         tree_threshold)
                     for w in workers], timeout=300)
                return (sum(p[0] for p in parts),
                        sum(p[1] for p in parts))

            tree = _grow_tree(hist_fn, cfg.max_depth, cfg.reg_lambda,
                              cfg.min_child_weight, F, n_bins,
                              tree_feature, tree_threshold, tree_value)
            trees.append(tree)
            outs = ray_tpu_torch.get(
                [w.finish_round.remote(tree.feature, tree.threshold,
                                       tree.value, cfg.learning_rate)
                 for w in workers], timeout=300)
            train_metric = float(
                sum(m * c for m, c in outs) / sum(c for _, c in outs))
            row = {"round": rnd, "train_metric": train_metric}
            if self.valid is not None:
                valid_margin += cfg.learning_rate * \
                    tree.apply_binned(xb_v)
                row["valid_metric"] = _metric(
                    cfg.objective, valid_margin, yv)
            history.append(row)
        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        model = BoostingModel(trees, bin_edges, cfg.objective, base,
                              cfg.learning_rate)
        return BoostingResult(model, history)
