"""DQN: off-policy learning over a replay-buffer actor.

The off-policy half of the reference's algorithm matrix (reference:
python/ray/rllib/algorithms/dqn/dqn.py + utils/replay_buffers/ — env
runners feed a replay buffer, the learner samples uniformly and applies
double-DQN updates against a periodically-synced target network): the
replay buffer is a runtime actor holding numpy ring storage.

The port of ``ray_tpu/rllib/dqn.py``. The Q net, its target copy and
the Adam state live on ``DQNConfig.device`` (None is the card); the K
minibatch steps of an iteration run there back to back, and the loss is
read back once per ``train()``. The buffer and the ε-greedy runners are
CPU processes, as the reference places them.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.bridge import rl_params_from_jax, rl_params_to_jax
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.nets import Adam, Net, adam, to_device
from ray_tpu_torch.rllib.ppo import pin_runner_threads
from ray_tpu_torch.rllib.rollout import collect


# --- Q network (MLP, same init scheme as ppo.init_policy) ---------------

class QNet(Net):
    """Trunk + Q head ``q`` (init 0.01)."""

    def __init__(self, generator: torch.Generator, obs_dim: int,
                 n_actions: int, hidden: Sequence[int] = (64, 64)):
        super().__init__(generator, (obs_dim, *hidden),
                         {"q": (n_actions, 0.01)})

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (B, obs_dim) -> q-values (B, A)."""
        return self.heads["q"](self.features(obs))


def init_q(generator: torch.Generator, obs_dim: int, n_actions: int,
           hidden=(64, 64)) -> QNet:
    """A CPU ``QNet`` drawn from ``generator``; move it with ``.to``."""
    return QNet(generator, obs_dim, n_actions, hidden)


def q_forward(q: QNet, obs: torch.Tensor) -> torch.Tensor:
    """obs (B, obs_dim) -> q-values (B, A)."""
    return q(obs)


# --- replay buffer actor ------------------------------------------------

@ray_tpu_torch.remote
class ReplayBuffer:
    """Uniform ring replay (reference:
    rllib/utils/replay_buffers/replay_buffer.py). Stores flat numpy
    transition arrays; sampling returns a dict of stacked minibatches so
    the learner takes them in one transfer."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 act_shape: tuple = (), act_dtype: str = "int32"):
        # act_shape/act_dtype generalize the buffer to continuous
        # control (SAC stores float torque vectors; DQN int indices)
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, *act_shape),
                                np.dtype(act_dtype))
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.idx = 0
        self.full = False
        self.rng = np.random.default_rng(seed)

    def add(self, batch: Dict[str, np.ndarray]) -> int:
        n = len(batch["actions"])
        ids = (self.idx + np.arange(n)) % self.capacity
        self.obs[ids] = batch["obs"]
        self.next_obs[ids] = batch["next_obs"]
        self.actions[ids] = batch["actions"]
        self.rewards[ids] = batch["rewards"]
        self.dones[ids] = batch["dones"]
        self.idx = int((self.idx + n) % self.capacity)
        self.full = self.full or self.idx < n or self.idx == 0
        return len(self)

    def __len__(self):
        return self.capacity if self.full else self.idx

    def size(self) -> int:
        return len(self)

    def sample(self, batch_size: int, num_batches: int):
        """(num_batches, batch_size, ...) stacked minibatches, or None
        until the buffer holds at least one batch."""
        n = len(self)
        if n < batch_size:
            return None
        ids = self.rng.integers(0, n, size=(num_batches, batch_size))
        return {"obs": self.obs[ids], "next_obs": self.next_obs[ids],
                "actions": self.actions[ids],
                "rewards": self.rewards[ids], "dones": self.dones[ids]}


# --- exploration actor --------------------------------------------------

@ray_tpu_torch.remote
class DQNRunner:
    """Epsilon-greedy transition collector (reference:
    rllib/env/single_agent_env_runner.py under DQN's config), with a
    CPU copy of the Q net."""

    def __init__(self, env_name: str, num_envs: int, steps_per_call: int,
                 seed: int, hidden=(64, 64)):
        pin_runner_threads()
        self.env = make_env(env_name, num_envs, seed)
        self.steps_per_call = steps_per_call
        self.obs = self.env.reset_all()
        self.rng = np.random.default_rng(seed)
        self.ep_ret = np.zeros(num_envs, np.float32)
        self.done_returns = deque(maxlen=100)
        self.q = init_q(torch.Generator(), self.env.OBS_DIM,
                        self.env.N_ACTIONS, hidden)

    def sample(self, params: dict, epsilon: float
               ) -> Dict[str, np.ndarray]:
        pin_runner_threads()
        rl_params_from_jax(params, self.q)

        def act(obs):
            with torch.no_grad():
                q = self.q(torch.from_numpy(obs)).numpy()
            greedy = q.argmax(axis=1)
            rand = self.rng.integers(0, q.shape[1], size=len(greedy))
            explore = self.rng.random(len(greedy)) < epsilon
            return np.where(explore, rand, greedy).astype(np.int32)

        batch, self.obs = collect(self.env, self.obs,
                                  self.steps_per_call, act,
                                  self.ep_ret, self.done_returns)
        return batch


# --- learner ------------------------------------------------------------

def dqn_update(q: QNet, target_q: QNet, opt: Adam,
               batches: dict, *, gamma: float = 0.99) -> torch.Tensor:
    """Double DQN over a stack of minibatches (K, B, ...), one Adam step
    each, in place on ``q`` and ``opt``. The online net picks the next
    action, the target net scores it. Returns the mean loss as a device
    scalar."""
    actions = batches["actions"].long()
    losses = []
    for k in range(actions.shape[0]):
        q_sel = q(batches["obs"][k]).gather(1, actions[k, :, None])[:, 0]
        with torch.no_grad():
            next_a = q(batches["next_obs"][k]).argmax(dim=1)
            next_q = target_q(batches["next_obs"][k]).gather(
                1, next_a[:, None])[:, 0]
            target = batches["rewards"][k] + gamma * (
                1.0 - batches["dones"][k]) * next_q
        loss = torch.mean((q_sel - target) ** 2)
        opt.minimize(loss)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


@dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    steps_per_call: int = 32          # env steps per runner per iteration
    buffer_capacity: int = 50_000
    learning_starts: int = 500        # min transitions before updates
    batch_size: int = 64
    updates_per_iter: int = 16
    target_sync_every: int = 4        # iterations between target syncs
    gamma: float = 0.99
    lr: float = 1e-3
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 40
    hidden: tuple = (64, 64)
    seed: int = 0
    runner_options: dict = field(default_factory=dict)
    # the learner's device: None is the card (raises without one)
    device: Optional[str] = None


class DQN:
    def __init__(self, config: DQNConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, 1, 0)
        self.obs_dim, self.n_actions = env.OBS_DIM, env.N_ACTIONS
        self.q = init_q(torch.Generator().manual_seed(config.seed),
                        self.obs_dim, self.n_actions,
                        config.hidden).to(self.device)
        self.target_q = copy.deepcopy(self.q).requires_grad_(False)
        self.opt = adam(self.q.parameters(), config.lr)
        self.buffer = ReplayBuffer.remote(
            config.buffer_capacity, self.obs_dim, config.seed)
        self.runners = [
            DQNRunner.options(**config.runner_options).remote(
                config.env, config.num_envs_per_runner,
                config.steps_per_call, config.seed + 100 + i,
                config.hidden)
            for i in range(config.num_env_runners)]
        self._iter = 0

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self._iter / max(c.epsilon_decay_iters, 1))
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def train(self) -> dict:
        """One iteration: parallel exploration -> buffer add -> K
        double-DQN minibatch updates -> (periodic) target sync."""
        self._iter += 1
        c = self.cfg
        eps = self.epsilon()
        t0 = time.perf_counter()
        host_params = self.get_policy_params()
        batches = ray_tpu_torch.get(
            [r.sample.remote(host_params, eps) for r in self.runners],
            timeout=300)
        ep_rets = [b.pop("episode_returns") for b in batches]
        sizes = ray_tpu_torch.get(
            [self.buffer.add.remote(b) for b in batches], timeout=300)
        loss = float("nan")
        t2 = time.perf_counter()
        if sizes[-1] >= max(c.learning_starts, c.batch_size):
            mbs = ray_tpu_torch.get(self.buffer.sample.remote(
                c.batch_size, c.updates_per_iter), timeout=300)
            t2 = time.perf_counter()
            if mbs is not None:
                mbs = {k: to_device(v, self.device)
                       for k, v in mbs.items()}
                loss = float(dqn_update(self.q, self.target_q, self.opt,
                                        mbs, gamma=c.gamma))
        if self._iter % c.target_sync_every == 0:
            self.target_q.load_state_dict(self.q.state_dict())
        t3 = time.perf_counter()
        ep = np.concatenate([e for e in ep_rets if len(e)]) \
            if any(len(e) for e in ep_rets) else np.array([0.0])
        return {"training_iteration": self._iter,
                "episode_reward_mean": float(ep.mean()),
                "loss": loss, "epsilon": eps,
                "buffer_size": int(sizes[-1]),
                "timesteps_this_iter": int(
                    c.num_env_runners * c.num_envs_per_runner
                    * c.steps_per_call),
                # exploration, buffer adds and the minibatch fetch; the
                # updates, read back once
                "timers": {"sample_s": t2 - t0, "learn_s": t3 - t2}}

    def get_policy_params(self) -> dict:
        """The Q net as the reference's numpy dict (``x @ W``)."""
        return rl_params_to_jax(self.q)
