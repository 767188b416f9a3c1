"""SAC: continuous-action off-policy learning (squashed-Gaussian actor,
twin critics, learned temperature).

The continuous-control column of the reference's algorithm matrix
(reference: python/ray/rllib/algorithms/sac/sac.py +
sac_learner/torch/sac_torch_learner.py — env runners feed a replay
buffer; the learner does twin-Q TD against polyak target critics, a
reparameterized squashed-Gaussian policy update through min(Q1,Q2), and
dual-descent temperature toward a target entropy).

The port of ``ray_tpu/rllib/sac.py``. The actor, the critics, the target
critics, ``log_alpha`` and the three Adam states live on
``SACConfig.device`` (None is the card). Each minibatch step (critic,
actor, temperature, polyak sync) runs there as eager ops, the Gaussian
noise is drawn on the host from a seeded generator and passed in, and
the losses are read back once per ``train()``.
"""

from __future__ import annotations

import copy
import time
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.bridge import rl_params_from_jax, rl_params_to_jax
from ray_tpu_torch.rllib.dqn import ReplayBuffer
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.nets import Net, adam, to_device
from ray_tpu_torch.rllib.ppo import pin_runner_threads
from ray_tpu_torch.rllib.rollout import collect

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


# --- networks -----------------------------------------------------------

class Actor(Net):
    """Trunk + ``mu`` and ``ls`` (log std) heads, both init 0.01."""

    def __init__(self, generator: torch.Generator, obs_dim: int,
                 act_dim: int, hidden: Sequence[int] = (64, 64)):
        super().__init__(generator, (obs_dim, *hidden),
                         {"mu": (act_dim, 0.01), "ls": (act_dim, 0.01)})

    def forward(self, obs: torch.Tensor):
        """obs (B, O) -> (mu, log_std) of the pre-squash Gaussian."""
        h = self.features(obs)
        return self.heads["mu"](h), torch.clamp(
            self.heads["ls"](h), LOG_STD_MIN, LOG_STD_MAX)


class QHead(Net):
    """One Q network over concat(obs, act): trunk + ``out`` (init 1.0)."""

    def __init__(self, generator: torch.Generator, in_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__(generator, (in_dim, *hidden), {"out": (1, 1.0)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.heads["out"](self.features(x))[:, 0]


class Critic(nn.Module):
    """Twin Q networks ``q1``/``q2`` (the reference's nested tree)."""

    def __init__(self, generator: torch.Generator, obs_dim: int,
                 act_dim: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.q1 = QHead(generator, obs_dim + act_dim, hidden)
        self.q2 = QHead(generator, obs_dim + act_dim, hidden)

    def forward(self, obs: torch.Tensor, act: torch.Tensor):
        """-> (q1, q2), each (B,)."""
        x = torch.cat([obs, act], dim=-1)
        return self.q1(x), self.q2(x)


def init_actor(generator: torch.Generator, obs_dim: int, act_dim: int,
               hidden=(64, 64)) -> Actor:
    return Actor(generator, obs_dim, act_dim, hidden)


def init_critic(generator: torch.Generator, obs_dim: int, act_dim: int,
                hidden=(64, 64)) -> Critic:
    return Critic(generator, obs_dim, act_dim, hidden)


def actor_dist(actor: Actor, obs: torch.Tensor):
    """obs (B, O) -> (mu, log_std) of the pre-squash Gaussian."""
    return actor(obs)


def q_values(critic: Critic, obs: torch.Tensor, act: torch.Tensor):
    """-> (q1, q2), each (B,)."""
    return critic(obs, act)


def sample_action(actor: Actor, obs: torch.Tensor, noise: torch.Tensor,
                  action_high: float):
    """Reparameterized squashed-Gaussian sample from standard normal
    ``noise`` (B, act_dim) -> (action, log_prob)."""
    mu, log_std = actor(obs)
    std = torch.exp(log_std)
    u = mu + std * noise
    a = torch.tanh(u)
    # log prob with tanh change-of-variables (numerically-stable form)
    logp = (-0.5 * (((u - mu) / std) ** 2 + 2 * log_std
                    + math.log(2 * math.pi))).sum(-1)
    logp = logp - (2 * (math.log(2.0) - u - F.softplus(-2 * u))).sum(-1)
    return a * action_high, logp


# --- exploration actor --------------------------------------------------

@ray_tpu_torch.remote
class SACRunner:
    """Stochastic-policy transition collector (exploration comes from
    the squashed-Gaussian itself; before learning starts, uniform
    random torque seeds the buffer — reference: sac.py
    num_steps_sampled_before_learning_starts), with a CPU copy of the
    actor."""

    def __init__(self, env_name: str, num_envs: int, steps_per_call: int,
                 seed: int, hidden=(64, 64)):
        pin_runner_threads()
        self.env = make_env(env_name, num_envs, seed)
        self.steps_per_call = steps_per_call
        self.obs = self.env.reset_all()
        self.gen = torch.Generator().manual_seed(seed)
        self.rng = np.random.default_rng(seed)
        self.ep_ret = np.zeros(num_envs, np.float32)
        self.done_returns = deque(maxlen=100)
        self.actor = init_actor(torch.Generator(), self.env.OBS_DIM,
                                self.env.ACTION_DIM, hidden)

    def sample(self, params: dict, random_actions: bool = False
               ) -> Dict[str, np.ndarray]:
        pin_runner_threads()
        rl_params_from_jax(params, self.actor)
        hi = self.env.ACTION_HIGH

        def act(obs):
            if random_actions:
                return self.rng.uniform(
                    -hi, hi, size=(self.env.num_envs,
                                   self.env.ACTION_DIM)
                ).astype(np.float32)
            noise = torch.randn((len(obs), self.env.ACTION_DIM),
                                generator=self.gen)
            with torch.no_grad():
                a, _ = sample_action(self.actor, torch.from_numpy(obs),
                                     noise, hi)
            return a.numpy()

        batch, self.obs = collect(self.env, self.obs,
                                  self.steps_per_call, act,
                                  self.ep_ret, self.done_returns)
        return batch


# --- learner ------------------------------------------------------------

def sac_update(actor: Actor, critic: Critic, target_critic: Critic,
               log_alpha: torch.Tensor, opts, batches: dict,
               noise: torch.Tensor, *, gamma: float = 0.99,
               tau: float = 0.005, action_high: float = 1.0,
               target_entropy: float = -1.0) -> torch.Tensor:
    """Per minibatch of ``batches`` (K, B, ...): a critic TD step against
    the polyak target, a reparameterized actor step through min(Q1, Q2)
    of the critic just updated, a temperature step on ``log_alpha`` and
    the polyak sync at ``tau``, in place. ``opts`` = (actor's, critic's,
    log_alpha's Adam); ``noise`` (K, 2, B, act_dim): the standard normal
    draws for the critic's next action and the actor's action. Returns
    the mean (critic, actor, alpha) losses as a device (3,) tensor."""
    opt_a, opt_c, opt_al = opts
    c_params = list(critic.parameters())
    tc_params = list(target_critic.parameters())
    losses = []
    for k in range(noise.shape[0]):
        obs, next_obs = batches["obs"][k], batches["next_obs"][k]
        with torch.no_grad():
            next_a, next_logp = sample_action(actor, next_obs,
                                              noise[k, 0], action_high)
            tq1, tq2 = target_critic(next_obs, next_a)
            backup = batches["rewards"][k] + gamma * (
                1.0 - batches["dones"][k]) * (
                torch.minimum(tq1, tq2) - torch.exp(log_alpha) * next_logp)
        q1, q2 = critic(obs, batches["actions"][k])
        cl = torch.mean((q1 - backup) ** 2 + (q2 - backup) ** 2)
        opt_c.minimize(cl)
        act, logp = sample_action(actor, obs, noise[k, 1], action_high)
        q1, q2 = critic(obs, act)
        al = torch.mean(torch.exp(log_alpha) * logp - torch.minimum(q1, q2))
        opt_a.minimize(al)
        # dual descent: alpha rises while entropy < target
        all_ = -torch.mean(log_alpha * (logp.detach() + target_entropy))
        opt_al.minimize(all_)
        with torch.no_grad():
            torch._foreach_mul_(tc_params, 1 - tau)
            torch._foreach_add_(tc_params, c_params, alpha=tau)
        losses.append(torch.stack([cl, al, all_]).detach())
    return torch.stack(losses).mean(dim=0)


@dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_env_runners: int = 1
    num_envs_per_runner: int = 8
    steps_per_call: int = 64          # env steps per runner per iteration
    buffer_capacity: int = 100_000
    learning_starts: int = 512        # min transitions before updates
    batch_size: int = 128
    updates_per_iter: int = 32
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    init_alpha: float = 0.1
    target_entropy: float = None      # default: -action_dim
    hidden: tuple = (64, 64)
    seed: int = 0
    runner_options: dict = field(default_factory=dict)
    # the learner's device: None is the card (raises without one)
    device: Optional[str] = None


class SAC:
    def __init__(self, config: SACConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, 1, 0)
        if not getattr(env, "CONTINUOUS", False):
            raise ValueError(
                f"SAC needs a continuous-action env; {config.env!r} "
                "is discrete (use DQN/PPO/IMPALA)")
        self.obs_dim, self.act_dim = env.OBS_DIM, env.ACTION_DIM
        self.action_high = float(env.ACTION_HIGH)
        self.target_entropy = (config.target_entropy
                               if config.target_entropy is not None
                               else -float(self.act_dim))
        gen = torch.Generator().manual_seed(config.seed)
        self.actor = init_actor(gen, self.obs_dim, self.act_dim,
                                config.hidden).to(self.device)
        self.critic = init_critic(gen, self.obs_dim, self.act_dim,
                                  config.hidden).to(self.device)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(
            False)
        self.log_alpha = torch.tensor(
            np.log(config.init_alpha), dtype=torch.float32,
            device=self.device, requires_grad=True)
        self.opts = (adam(self.actor.parameters(), config.lr),
                     adam(self.critic.parameters(), config.lr),
                     adam([self.log_alpha], config.lr))
        self.buffer = ReplayBuffer.remote(
            config.buffer_capacity, self.obs_dim, config.seed,
            act_shape=(self.act_dim,), act_dtype="float32")
        self.runners = [
            SACRunner.options(**config.runner_options).remote(
                config.env, config.num_envs_per_runner,
                config.steps_per_call, config.seed + 100 + i,
                config.hidden)
            for i in range(config.num_env_runners)]
        self._iter = 0
        self.gen = torch.Generator().manual_seed(config.seed + 1)

    def train(self) -> dict:
        """One iteration: parallel exploration -> buffer add -> K SAC
        minibatch updates (critic, actor, alpha, polyak each)."""
        self._iter += 1
        c = self.cfg
        t0 = time.perf_counter()
        host_actor = self.get_policy_params()
        warmup = (self._iter * c.num_env_runners
                  * c.num_envs_per_runner * c.steps_per_call
                  <= c.learning_starts)
        batches = ray_tpu_torch.get(
            [r.sample.remote(host_actor, warmup) for r in self.runners],
            timeout=300)
        ep_rets = [b.pop("episode_returns") for b in batches]
        sizes = ray_tpu_torch.get(
            [self.buffer.add.remote(b) for b in batches], timeout=300)
        losses = (float("nan"),) * 3
        alpha = float(torch.exp(self.log_alpha.detach()))
        t2 = time.perf_counter()
        if sizes[-1] >= max(c.learning_starts, c.batch_size):
            mbs = ray_tpu_torch.get(self.buffer.sample.remote(
                c.batch_size, c.updates_per_iter), timeout=300)
            t2 = time.perf_counter()
            if mbs is not None:
                mbs = {k: to_device(v, self.device)
                       for k, v in mbs.items()}
                noise = torch.randn(
                    (c.updates_per_iter, 2, c.batch_size, self.act_dim),
                    generator=self.gen)
                ls = sac_update(
                    self.actor, self.critic, self.target_critic,
                    self.log_alpha, self.opts, mbs,
                    noise.to(self.device), gamma=c.gamma, tau=c.tau,
                    action_high=self.action_high,
                    target_entropy=self.target_entropy)
                losses = tuple(float(x) for x in ls.cpu())
        t3 = time.perf_counter()
        ep = np.concatenate([e for e in ep_rets if len(e)]) \
            if any(len(e) for e in ep_rets) else np.array([0.0])
        return {"training_iteration": self._iter,
                "episode_reward_mean": float(ep.mean()),
                "critic_loss": losses[0], "actor_loss": losses[1],
                "alpha": alpha, "buffer_size": int(sizes[-1]),
                "timesteps_this_iter": int(
                    c.num_env_runners * c.num_envs_per_runner
                    * c.steps_per_call),
                # exploration, buffer adds and the minibatch fetch; the
                # updates, read back once
                "timers": {"sample_s": t2 - t0, "learn_s": t3 - t2}}

    def get_policy_params(self) -> dict:
        """The actor as the reference's numpy dict (``x @ W``)."""
        return rl_params_to_jax(self.actor)
