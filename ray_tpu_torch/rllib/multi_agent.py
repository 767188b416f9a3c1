"""Multi-agent training: per-agent dict envs through a shared rollout
collector, one policy per policy id with an agent->policy mapping.

Reference: python/ray/rllib/env/multi_agent_env.py (per-agent
obs/action/reward dicts) + the multi-agent config surface
(policies + policy_mapping_fn on AlgorithmConfig.multi_agent). Each
policy's update stays ONE ppo_update over (T, N_agents_mapped *
num_envs) — agents sharing a policy batch into the same matmul, they
don't loop.

The port of ``ray_tpu/rllib/multi_agent.py``: the policies and their
Adam states on ``MultiAgentPPOConfig.device`` (None is the card), the
shared collector a CPU process with a CPU copy of each policy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.bridge import rl_params_from_jax, rl_params_to_jax
from ray_tpu_torch.rllib.env import MULTI_AGENT_ENVS
from ray_tpu_torch.rllib.nets import Adam, adam
from ray_tpu_torch.rllib.ppo import (act, concat_fragments, draw_perms,
                                     gae_batch, init_policy,
                                     pin_runner_threads, ppo_update)


def make_multi_agent_env(name: str, num_envs: int, seed: int = 0):
    try:
        return MULTI_AGENT_ENVS[name](num_envs, seed)
    except KeyError:
        raise ValueError(
            f"unknown multi-agent env {name!r}; register it in "
            f"ray_tpu_torch.rllib.env.MULTI_AGENT_ENVS")


@ray_tpu_torch.remote
class MultiAgentEnvRunner:
    """Shared rollout collector: ONE env step advances every agent;
    actions come from each agent's mapped policy (reference:
    rllib/env/multi_agent_env_runner.py sample())."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 seed: int, mapping: Dict[str, str], hidden=(64, 64)):
        pin_runner_threads()
        self.env = make_multi_agent_env(env_name, num_envs, seed)
        self.rollout_len = rollout_len
        self.mapping = mapping
        self.obs = self.env.reset_all()
        self.gen = torch.Generator().manual_seed(seed)
        self.ep_ret = {a: np.zeros(num_envs, np.float32)
                       for a in self.env.agents}
        self.done_returns = {a: [] for a in self.env.agents}
        self.policies = {
            pid: init_policy(torch.Generator(), self.env.OBS_DIM,
                             self.env.N_ACTIONS, hidden)
            for pid in sorted(set(mapping.values()))}

    def sample(self, params_by_policy: Dict[str, dict]
               ) -> Dict[str, Dict[str, np.ndarray]]:
        """One fragment per agent: {agent: {obs (T,N,D), actions, logp,
        values, rewards, dones (T,N), last_value, last_obs,
        episode_returns}}."""
        pin_runner_threads()
        for pid, policy in self.policies.items():
            rl_params_from_jax(params_by_policy[pid], policy)
        agents = self.env.agents
        out = {a: {k: [] for k in ("obs", "actions", "logp", "values",
                                   "rewards", "dones")}
               for a in agents}
        for _ in range(self.rollout_len):
            actions = {}
            for a in agents:
                actions[a], logp, v = act(
                    self.policies[self.mapping[a]], self.obs[a], self.gen)
                out[a]["obs"].append(self.obs[a])
                out[a]["actions"].append(actions[a])
                out[a]["logp"].append(logp)
                out[a]["values"].append(v)
            obs2, rew, done = self.env.step(actions)
            for a in agents:
                out[a]["rewards"].append(rew[a])
                out[a]["dones"].append(done[a].astype(np.float32))
                self.ep_ret[a] += rew[a]
                if done[a].any():
                    for i in np.where(done[a])[0]:
                        self.done_returns[a].append(
                            float(self.ep_ret[a][i]))
                        self.ep_ret[a][i] = 0.0
                    self.done_returns[a] = self.done_returns[a][-100:]
            self.obs = obs2
        frags = {}
        for a in agents:
            with torch.no_grad():
                _, last_v = self.policies[self.mapping[a]](
                    torch.from_numpy(self.obs[a]))
            frag = {k: np.stack(v) for k, v in out[a].items()}
            frag["last_value"] = last_v.numpy()
            frag["last_obs"] = np.asarray(self.obs[a])
            frag["episode_returns"] = np.array(
                self.done_returns[a], np.float32)
            frags[a] = frag
        return frags


@dataclass
class MultiAgentPPOConfig:
    env: str = "MultiCartPole-v0"
    num_env_runners: int = 1
    num_envs_per_runner: int = 8
    rollout_len: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 4
    minibatches: int = 4
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # agent id -> policy id; None = one INDEPENDENT policy per agent.
    # Mapping several agents onto one id trains a SHARED policy on
    # their pooled experience (reference: policy_mapping_fn).
    policy_mapping: Optional[Dict[str, str]] = None
    runner_options: dict = field(default_factory=dict)
    # the learners' device: None is the card (raises without one)
    device: Optional[str] = None


def pool_fragments(results, agents, mapping: Dict[str, str], pid: str
                   ) -> dict:
    """Every fragment of every agent mapped to ``pid``, runner by runner
    and agent by agent in ``agents``' order, pooled along the env axis."""
    return concat_fragments([res[a] for res in results for a in agents
                             if mapping[a] == pid])


class MultiAgentPPO:
    """Independent/shared-policy PPO over a multi-agent env."""

    def __init__(self, config: MultiAgentPPOConfig):
        self.cfg = config
        env = make_multi_agent_env(config.env, 1, 0)
        self.agents = tuple(env.agents)
        self.mapping = dict(config.policy_mapping or
                            {a: a for a in self.agents})
        missing = [a for a in self.agents if a not in self.mapping]
        if missing:
            raise ValueError(f"policy_mapping lacks agents: {missing}")
        unknown = [a for a in self.mapping if a not in self.agents]
        if unknown:
            raise ValueError(
                f"policy_mapping names unknown agents {unknown}; env "
                f"{config.env!r} has {list(self.agents)}")
        self.device = resolve_device(config.device)
        self.policies = tuple(sorted(set(self.mapping.values())))
        self.nets: Dict[str, torch.nn.Module] = {}
        self.opt: Dict[str, Adam] = {}
        for i, pid in enumerate(self.policies):
            self.nets[pid] = init_policy(
                torch.Generator().manual_seed(config.seed + i),
                env.OBS_DIM, env.N_ACTIONS, config.hidden).to(self.device)
            self.opt[pid] = adam(self.nets[pid].parameters(), config.lr)
        self.gen = torch.Generator().manual_seed(config.seed + 1)
        self.runners = [
            MultiAgentEnvRunner.options(**config.runner_options).remote(
                config.env, config.num_envs_per_runner,
                config.rollout_len, config.seed + 100 + i, self.mapping,
                config.hidden)
            for i in range(config.num_env_runners)]
        self._iter = 0

    def train(self) -> dict:
        c = self.cfg
        self._iter += 1
        t0 = time.perf_counter()
        host = {pid: rl_params_to_jax(p) for pid, p in self.nets.items()}
        results = ray_tpu_torch.get(
            [r.sample.remote(host) for r in self.runners], timeout=300)
        t1 = time.perf_counter()
        rewards = {}
        losses = {}
        for pid in self.policies:
            # pool every fragment of every agent mapped to this policy
            # along the env axis -> ONE (T, N_total) update
            batch = gae_batch(
                pool_fragments(results, self.agents, self.mapping, pid),
                self.device, c.gamma, c.lam)
            perms = draw_perms(self.gen, c.epochs,
                               batch["obs"].shape[0]
                               * batch["obs"].shape[1])
            losses[pid] = ppo_update(
                self.nets[pid], self.opt[pid], batch,
                perms.to(self.device), clip=c.clip,
                minibatches=c.minibatches)
        losses = {pid: float(l) for pid, l in losses.items()}
        t2 = time.perf_counter()
        for a in self.agents:
            ep = np.concatenate(
                [res[a]["episode_returns"] for res in results
                 if len(res[a]["episode_returns"])]) \
                if any(len(res[a]["episode_returns"])
                       for res in results) else np.array([0.0])
            rewards[a] = float(ep.mean())
        return {
            "training_iteration": self._iter,
            "episode_reward_mean": float(np.mean(list(rewards.values()))),
            "agent_reward_mean": rewards,
            "policy_loss": losses,
            "timesteps_this_iter": int(
                c.num_env_runners * c.num_envs_per_runner
                * c.rollout_len * len(self.agents)),
            "timers": {"sample_s": t1 - t0, "learn_s": t2 - t1},
        }

    def get_policy_params(self, policy_id: Optional[str] = None) -> dict:
        if policy_id is None and len(self.policies) == 1:
            policy_id = self.policies[0]
        return rl_params_to_jax(self.nets[policy_id])

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
