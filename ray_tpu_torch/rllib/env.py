"""Vectorized environments (no gym dependency).

The env interface mirrors the reference's EnvRunner expectations
(reference: python/ray/rllib/env/single_agent_env_runner.py): numpy
in/out, batch-first, auto-reset on termination — the shape that keeps
the policy's forward pass one batched matmul per step.

The port's copy of ``ray_tpu/rllib/env.py``: the same numpy dynamics,
so under the same seed and actions the envs step bitwise alike.
"""

from __future__ import annotations

import numpy as np


class CartPoleVec:
    """Classic cart-pole dynamics, vectorized over `num_envs`.

    Physics per OpenAI's cartpole (public constants); termination at
    |x|>2.4 or |theta|>12deg or 500 steps; reward 1 per step.
    """

    OBS_DIM = 4
    N_ACTIONS = 2
    MAX_STEPS = 500

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros((num_envs, 4), np.float32)
        self.steps = np.zeros(num_envs, np.int32)
        self.reset_all()

    def reset_all(self) -> np.ndarray:
        self.state = self.rng.uniform(
            -0.05, 0.05, size=(self.num_envs, 4)).astype(np.float32)
        self.steps[:] = 0
        return self.state.copy()

    def step(self, actions: np.ndarray):
        """actions: (n,) in {0,1}. Returns (obs, reward, done) with
        auto-reset: `obs` is the NEXT episode's start where done."""
        g, mc, mp, length = 9.8, 1.0, 0.1, 0.5
        force_mag, tau = 10.0, 0.02
        total_m, pml = mc + mp, mp * length

        x, x_dot, th, th_dot = self.state.T
        force = np.where(actions == 1, force_mag, -force_mag)
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + pml * th_dot ** 2 * sin) / total_m
        th_acc = (g * sin - cos * temp) / (
            length * (4.0 / 3.0 - mp * cos ** 2 / total_m))
        x_acc = temp - pml * th_acc * cos / total_m
        x = x + tau * x_dot
        x_dot = x_dot + tau * x_acc
        th = th + tau * th_dot
        th_dot = th_dot + tau * th_acc
        self.state = np.stack([x, x_dot, th, th_dot], axis=1) \
            .astype(np.float32)
        self.steps += 1

        # truncated vs terminated matters for TD bootstrapping: a
        # time-limit cut is NOT a real terminal (the value of the next
        # state is not 0) — learners mask bootstrap with
        # done & ~truncated
        self.truncated = self.steps >= self.MAX_STEPS
        done = (np.abs(x) > 2.4) | (np.abs(th) > 12 * np.pi / 180) \
            | self.truncated
        reward = np.ones(self.num_envs, np.float32)
        if done.any():
            idx = np.where(done)[0]
            self.state[idx] = self.rng.uniform(
                -0.05, 0.05, size=(len(idx), 4)).astype(np.float32)
            self.steps[idx] = 0
        return self.state.copy(), reward, done


class PendulumVec:
    """Classic torque-controlled pendulum swing-up, vectorized —
    the continuous-action counterpart of CartPoleVec (dynamics per the
    public Pendulum-v1 spec: obs [cos th, sin th, thdot], action torque
    in [-2, 2], reward -(th^2 + 0.1 thdot^2 + 0.001 a^2), 200-step
    episodes, auto-reset)."""

    OBS_DIM = 3
    ACTION_DIM = 1
    ACTION_HIGH = 2.0
    CONTINUOUS = True
    MAX_STEPS = 200

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.rng = np.random.default_rng(seed)
        self.th = np.zeros(num_envs, np.float32)
        self.thdot = np.zeros(num_envs, np.float32)
        self.steps = np.zeros(num_envs, np.int32)
        self.reset_all()

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self.th), np.sin(self.th), self.thdot],
                        axis=1).astype(np.float32)

    def _reset_idx(self, idx) -> None:
        self.th[idx] = self.rng.uniform(-np.pi, np.pi, size=len(idx))
        self.thdot[idx] = self.rng.uniform(-1.0, 1.0, size=len(idx))
        self.steps[idx] = 0

    def reset_all(self) -> np.ndarray:
        self._reset_idx(np.arange(self.num_envs))
        return self._obs()

    def step(self, actions: np.ndarray):
        """actions: (n, 1) float torque. Returns (obs, reward, done);
        auto-resets at the 200-step horizon (time-limit done)."""
        g, m, length, dt = 10.0, 1.0, 1.0, 0.05
        u = np.clip(np.asarray(actions, np.float32).reshape(-1),
                    -self.ACTION_HIGH, self.ACTION_HIGH)
        th_norm = ((self.th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm ** 2 + 0.1 * self.thdot ** 2 + 0.001 * u ** 2
        self.thdot = np.clip(
            self.thdot + (3 * g / (2 * length) * np.sin(self.th)
                          + 3.0 / (m * length ** 2) * u) * dt,
            -8.0, 8.0).astype(np.float32)
        self.th = (self.th + self.thdot * dt).astype(np.float32)
        self.steps += 1
        done = self.steps >= self.MAX_STEPS
        # every pendulum "done" is a time-limit truncation, never a
        # true terminal — learners must keep bootstrapping through it
        self.truncated = done.copy()
        if done.any():
            self._reset_idx(np.where(done)[0])
        return self._obs(), (-cost).astype(np.float32), done


class MultiCartPoleVec:
    """Two-agent cart-pole: each agent balances its OWN pole, with
    per-agent obs/action/reward/done DICTS — the multi-agent env
    contract (reference: rllib/env/multi_agent_env.py; the reference's
    own MultiAgentCartPole example is likewise N independent poles).
    Vectorized over num_envs per agent."""

    AGENTS = ("agent_0", "agent_1")
    OBS_DIM = 4
    N_ACTIONS = 2

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self._envs = {a: CartPoleVec(num_envs, seed + 17 * i)
                      for i, a in enumerate(self.AGENTS)}

    @property
    def agents(self):
        return self.AGENTS

    def reset_all(self):
        return {a: e.reset_all() for a, e in self._envs.items()}

    def step(self, actions):
        """actions: {agent: (n,)}. Returns ({agent: obs}, {agent: r},
        {agent: done}) — each agent's envs auto-reset independently."""
        obs, rew, done = {}, {}, {}
        for a, e in self._envs.items():
            obs[a], rew[a], done[a] = e.step(actions[a])
        return obs, rew, done


ENVS = {"CartPole-v1": CartPoleVec, "Pendulum-v1": PendulumVec}
MULTI_AGENT_ENVS = {"MultiCartPole-v0": MultiCartPoleVec}


def make_env(name: str, num_envs: int, seed: int = 0):
    try:
        return ENVS[name](num_envs, seed)
    except KeyError:
        raise ValueError(
            f"unknown env {name!r}; register it in "
            "ray_tpu_torch.rllib.env.ENVS")
