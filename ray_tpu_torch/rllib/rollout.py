"""Shared transition collector for off-policy env runners.

One loop used by DQN and SAC runners (reference: the common
EnvRunner._sample machinery under rllib/env/single_agent_env_runner.py)
— action selection is the only per-algorithm piece, passed as a
callback. Stored ``dones`` are TERMINALS ONLY (``done & ~truncated``):
a time-limit truncation is not a real terminal, so the TD target keeps
bootstrapping through it; episode-return accounting uses the raw done.

The port's copy of ``ray_tpu/rllib/rollout.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


def collect(env, obs: np.ndarray, steps: int,
            act: Callable[[np.ndarray], np.ndarray],
            ep_ret: np.ndarray, done_returns
            ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Run `steps` vectorized env steps; returns (batch, next_obs)."""
    out: Dict[str, list] = {k: [] for k in
                            ("obs", "next_obs", "actions", "rewards",
                             "dones")}
    for _ in range(steps):
        a = act(obs)
        obs2, r, done = env.step(a)
        truncated = getattr(env, "truncated", None)
        terminal = done if truncated is None else (done & ~truncated)
        out["obs"].append(obs)
        # env auto-resets on done: obs2 rows where done are the NEXT
        # episode's start; the terminal mask (not raw done) zeroes the
        # bootstrap only where the episode truly ended
        out["next_obs"].append(obs2)
        out["actions"].append(a)
        out["rewards"].append(r)
        out["dones"].append(terminal.astype(np.float32))
        ep_ret += r
        if done.any():
            for i in np.where(done)[0]:
                done_returns.append(float(ep_ret[i]))
                ep_ret[i] = 0.0
        obs = obs2
    batch = {k: np.concatenate(v) for k, v in out.items()}
    batch["episode_returns"] = np.array(done_returns, np.float32)
    return batch, obs
