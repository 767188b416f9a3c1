"""Behavior cloning: offline RL from a logged transition dataset.

The offline column of the reference's algorithm matrix (reference:
python/ray/rllib/algorithms/bc/bc.py — learn a policy by supervised
imitation of a logged dataset, evaluated by rolling the cloned policy
in the env). The dataset rides ray_tpu_torch.data (any reader —
parquet, tfrecord, from_items).

The port of ``ray_tpu/rllib/bc.py``: the policy and its Adam state on
``BCConfig.device`` (None is the card), the K cross-entropy steps of an
iteration run there back to back, and the greedy evaluation rollouts
run the learner's own policy on its device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.bridge import rl_params_to_jax
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.nets import Adam, adam, to_device
from ray_tpu_torch.rllib.ppo import Policy, init_policy


def bc_update(policy: Policy, opt: Adam, batches: dict
              ) -> torch.Tensor:
    """Cross-entropy imitation over a stack of minibatches, one Adam step
    each, in place. batches: {"obs": (K, B, O), "actions": (K, B)}.
    Returns the mean loss as a device scalar."""
    actions = batches["actions"].long()
    losses = []
    for k in range(actions.shape[0]):
        logits, _v = policy(batches["obs"][k])
        nll = -F.log_softmax(logits, dim=-1).gather(
            1, actions[k, :, None])[:, 0]
        loss = nll.mean()
        opt.minimize(loss)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


@dataclass
class BCConfig:
    env: str = "CartPole-v1"          # for evaluation rollouts
    batch_size: int = 256
    updates_per_iter: int = 32
    lr: float = 1e-3
    hidden: tuple = (64, 64)
    eval_episodes: int = 8
    seed: int = 0
    # the learner's device: None is the card (raises without one)
    device: Optional[str] = None


class BC:
    """``BC(dataset, config).train()`` — dataset is a
    ray_tpu_torch.data Dataset (or any iterable of blocks) with ``obs``
    (row-major float) and ``action`` (int) columns."""

    def __init__(self, dataset, config: Optional[BCConfig] = None):
        self.cfg = config or BCConfig()
        env = make_env(self.cfg.env, 1, 0)
        self.obs_dim, self.n_actions = env.OBS_DIM, env.N_ACTIONS
        # materialize the logged data once (offline training data is
        # bounded; the reference's BC reads it through ray.data too)
        obs, act = [], []
        seen_cols = set()
        for b in dataset.iter_blocks():
            seen_cols.update(b.keys())
            if len(b.get("action", ())) and "obs" in b:
                obs.append(np.asarray(b["obs"], np.float32))
                act.append(np.asarray(b["action"], np.int64))
        if not obs:
            raise ValueError(
                "BC needs a dataset with 'obs' and 'action' columns; "
                f"got columns {sorted(seen_cols) or '(no rows)'}")
        self._obs = np.concatenate(obs)
        self._act = np.concatenate(act)
        if self._obs.shape[1] != self.obs_dim:
            raise ValueError(
                f"dataset obs dim {self._obs.shape[1]} != env obs dim "
                f"{self.obs_dim}")
        self.device = resolve_device(self.cfg.device)
        self.policy = init_policy(
            torch.Generator().manual_seed(self.cfg.seed), self.obs_dim,
            self.n_actions, self.cfg.hidden).to(self.device)
        self.opt = adam(self.policy.parameters(), self.cfg.lr)
        self._rng = np.random.default_rng(self.cfg.seed)
        self._iter = 0

    def train(self) -> dict:
        c = self.cfg
        self._iter += 1
        t0 = time.perf_counter()
        n = len(self._obs)
        ids = self._rng.integers(0, n, size=(c.updates_per_iter,
                                             c.batch_size))
        batches = {"obs": to_device(self._obs[ids], self.device),
                   "actions": to_device(self._act[ids], self.device)}
        loss = bc_update(self.policy, self.opt, batches).item()
        t1 = time.perf_counter()
        ret = self.evaluate(c.eval_episodes)
        return {"training_iteration": self._iter,
                "loss": loss,
                "episode_reward_mean": ret,
                "dataset_size": n,
                "timers": {"learn_s": t1 - t0,
                           "eval_s": time.perf_counter() - t1}}

    @torch.no_grad()
    def evaluate(self, episodes: int) -> float:
        """Greedy rollouts of the cloned policy, on the learner's
        device."""
        env = make_env(self.cfg.env, episodes, self.cfg.seed + 7)
        obs = env.reset_all()
        done_ret = []
        ep_ret = np.zeros(episodes, np.float32)
        for _ in range(env.MAX_STEPS + 1):
            logits, _v = self.policy(to_device(obs, self.device))
            a = logits.argmax(dim=1).cpu().numpy().astype(np.int32)
            obs, r, done = env.step(a)
            ep_ret += r
            if done.any():
                for i in np.where(done)[0]:
                    done_ret.append(float(ep_ret[i]))
                    ep_ret[i] = 0.0
            if len(done_ret) >= episodes:
                break
        return float(np.mean(done_ret)) if done_ret else 0.0

    def get_policy_params(self) -> dict:
        """The policy as the reference's numpy dict (``x @ W``)."""
        return rl_params_to_jax(self.policy)
