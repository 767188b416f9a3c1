"""Checkpoint bookkeeping: top-K retention + latest tracking.

Reference: v2/_internal/execution/checkpoint/checkpoint_manager.py:93 —
tracks reported checkpoints, retains top-K by a score attribute, exposes
the latest for resume.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.api import Checkpoint, CheckpointConfig


class CheckpointManager:
    def __init__(self, storage_path: Optional[str],
                 config: CheckpointConfig):
        self.storage_path = storage_path
        self.config = config
        self._tracked: List[Checkpoint] = []
        self.latest: Optional[Checkpoint] = None
        # The directory the durable resume pointer
        # (_latest_checkpoint.json) currently targets: retention must
        # NEVER delete it — a crash after deletion would leave the
        # restart path resolving a pointer to rubble. Updated by the
        # controller whenever a reported checkpoint advanced the
        # pointer, and by _recover_latest_checkpoint on resume.
        self.pointer_target: Optional[str] = None

    @staticmethod
    def _norm(p):
        from ray_tpu_torch.util import storage as _st
        if not p:
            return None
        return p if _st.is_remote(p) else os.path.abspath(p)

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> None:
        # Dedup by path: in SPMD training every rank may report the same
        # checkpoint; tracking duplicates would let retention rmtree a
        # still-live directory. Remote URIs compare verbatim, local
        # paths normalized.
        path = self._norm(checkpoint.path)
        for existing in self._tracked:
            if path and self._norm(existing.path) == path:
                existing.metrics = dict(metrics)
                self.latest = existing
                return
        checkpoint.metrics = dict(metrics)
        self.latest = checkpoint
        self._tracked.append(checkpoint)
        self._enforce_retention()

    def _score(self, ckpt: Checkpoint) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return 0.0
        v = ckpt.metrics.get(attr)
        return float(v) if v is not None else float("-inf")

    def best(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        if self.config.checkpoint_score_attribute is None:
            return self.latest
        reverse = self.config.checkpoint_score_order == "max"
        return sorted(self._tracked, key=self._score, reverse=reverse)[0]

    def _protected(self, ckpt: Checkpoint) -> bool:
        """Never a retention victim: the latest checkpoint (the resume
        candidate) and whatever directory the durable resume pointer
        currently targets (deleting it would turn the pointer into a
        dangling reference a crashed controller restarts into)."""
        if ckpt is self.latest:
            return True
        pt = self._norm(self.pointer_target)
        return pt is not None and self._norm(ckpt.path) == pt

    def _enforce_retention(self) -> None:
        keep = self.config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        reverse = self.config.checkpoint_score_order == "max"
        if self.config.checkpoint_score_attribute is None:
            worst_first = list(self._tracked)       # oldest first
        else:
            # score order puts the BEST first; victims come off the
            # tail, so walk it reversed (worst first)
            worst_first = sorted(self._tracked, key=self._score,
                                 reverse=reverse)[::-1]
        # Take exactly len - keep victims from the worst end, SKIPPING
        # protected entries and replacing each skip with the next-worst
        # candidate — a protected checkpoint among the victims must not
        # inflate the tracked set past num_to_keep forever (the old
        # skip-without-replace overshot by one per protected hit).
        excess = len(self._tracked) - keep
        victims = []
        for v in worst_first:
            if len(victims) >= excess:
                break
            if self._protected(v):
                continue
            victims.append(v)
        from ray_tpu_torch.util import storage as _st
        for v in victims:
            self._tracked.remove(v)
            if not v.path or not self.storage_path:
                continue
            if _st.is_remote(v.path):
                if v.path.startswith(self.storage_path.rstrip("/")):
                    try:
                        st, p = _st.get_storage(v.path)
                        st.delete_prefix(p + "/")
                    except Exception:
                        pass  # retention is best-effort
            elif os.path.isdir(v.path) and \
                    v.path.startswith(os.path.abspath(self.storage_path)):
                shutil.rmtree(v.path, ignore_errors=True)
