"""IMPALA: asynchronous actor-learner with V-trace off-policy correction.

Reference: python/ray/rllib/algorithms/impala/impala.py (async
EnvRunner sampling pipelined against the learner, importance-weighted
V-trace targets per Espeholt et al. 2018). The shape:

- rollout actors (the same EnvRunner PPO uses) sample with whatever
  params they were LAST handed — the learner never blocks on a full
  round of fragments,
- the learner drains whichever fragments are ready
  (``ray_tpu_torch.wait``), applies one V-trace update per fragment,
  and immediately re-dispatches that runner with fresh weights,
- staleness is therefore bounded by the pipeline depth (one in-flight
  fragment per runner), and the V-trace rho/c clips correct for it —
  the defining IMPALA trade.

The port of ``ray_tpu/rllib/impala.py``: the learner on
``IMPALAConfig.device`` (None is the card), the V-trace recursion a
reverse loop over T on the learner's device, losses and ratios read back
once per ``train()``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.bridge import rl_params_to_jax
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.nets import Adam, adam, to_device
from ray_tpu_torch.rllib.ppo import EnvRunner, _entropy, init_policy


@torch.no_grad()
def _vtrace(behavior_logp, target_logp, rewards, dones, values,
            last_value, gamma: float, rho_bar: float = 1.0,
            c_bar: float = 1.0):
    """V-trace targets (Espeholt et al. 2018, eqs. 1-2). All inputs
    (T, N); values under the TARGET policy. Returns (vs (T, N),
    pg_advantages (T, N)), detached: the targets carry no gradient."""
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = torch.clamp(ratio, max=c_bar)
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    not_done = 1.0 - dones
    deltas = rho * (rewards + gamma * v_next * not_done - values)
    coef = gamma * c * not_done
    corrections = torch.empty_like(deltas)
    acc = torch.zeros_like(last_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = torch.addcmul(deltas[t], coef[t], acc, out=corrections[t])
    vs = values + corrections
    vs_next = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * vs_next * not_done - values)
    return vs, pg_adv


def _vtrace_terms(policy, batch: dict, gamma: float, rho_bar: float,
                  c_bar: float):
    """The forward both V-trace learners share: (logits (T, N, A),
    values (T, N), target_logp (T, N), vs, pg_adv), with ``last_value``
    recomputed under the current params."""
    T, N = batch["actions"].shape
    logits, values = policy(batch["obs"].reshape(T * N, -1))
    logits = logits.reshape(T, N, -1)
    values = values.reshape(T, N)
    target_logp = F.log_softmax(logits, dim=-1).gather(
        -1, batch["actions"].long()[..., None])[..., 0]
    _, last_value = policy(batch["last_obs"])
    vs, pg_adv = _vtrace(batch["behavior_logp"], target_logp.detach(),
                         batch["rewards"], batch["dones"], values.detach(),
                         last_value.detach(), gamma, rho_bar=rho_bar,
                         c_bar=c_bar)
    return logits, values, target_logp, vs, pg_adv


def impala_update(policy, opt: Adam, batch: dict, *,
                  gamma: float = 0.99, vf_coef: float = 0.5,
                  ent_coef: float = 0.01, rho_bar: float = 1.0,
                  c_bar: float = 1.0):
    """One fragment's V-trace update, in place. batch: obs (T, N, D),
    actions / behavior_logp / rewards / dones (T, N), last_obs (N, D), on
    the policy's device. Returns (loss, mean raw ratio pi/mu) as device
    scalars."""
    logits, values, target_logp, vs, pg_adv = _vtrace_terms(
        policy, batch, gamma, rho_bar, c_bar)
    pi_loss = -(target_logp * pg_adv).mean()
    v_loss = ((values - vs) ** 2).mean()
    loss = pi_loss + vf_coef * v_loss - ent_coef * _entropy(logits)
    opt.minimize(loss)
    ratio = torch.exp(target_logp.detach() - batch["behavior_logp"])
    return loss.detach(), ratio.mean()


def fragment_batch(frag: dict, device: torch.device) -> dict:
    """A runner's fragment -> the V-trace learners' batch on ``device``;
    the update bootstraps from the runner's final observation, evaluated
    under the CURRENT params."""
    return {"obs": to_device(frag["obs"], device),
            "actions": to_device(frag["actions"], device),
            "behavior_logp": to_device(frag["logp"], device),
            "rewards": to_device(frag["rewards"], device),
            "dones": to_device(frag["dones"], device),
            "last_obs": to_device(frag["last_obs"], device)}


@dataclass
class IMPALAConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_len: int = 64
    lr: float = 6e-4
    gamma: float = 0.99
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    rho_bar: float = 1.0        # V-trace importance clips
    c_bar: float = 1.0
    # fragments consumed per train() call; runners keep sampling
    # regardless (async pipeline)
    fragments_per_iter: int = 2
    hidden: tuple = (64, 64)
    seed: int = 0
    runner_options: dict = field(default_factory=dict)
    # the learner's device: None is the card (raises without one)
    device: Optional[str] = None


class IMPALA:
    """Async actor-learner. `train()` consumes whatever fragments are
    ready (never a barrier over all runners) and re-dispatches each
    producer with fresh weights."""

    def __init__(self, config: IMPALAConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, 1, 0)
        self.obs_dim, self.n_actions = env.OBS_DIM, env.N_ACTIONS
        self.policy = init_policy(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.n_actions, config.hidden).to(self.device)
        self.opt = adam(self.policy.parameters(), config.lr)
        self.runners: List = [
            EnvRunner.options(**config.runner_options).remote(
                config.env, config.num_envs_per_runner,
                config.rollout_len, config.seed + 100 + i, config.hidden)
            for i in range(config.num_env_runners)]
        # ref -> runner index; every runner always has one fragment
        # in flight (sampled with the weights it was last handed)
        self._inflight: Dict = {}
        host_params = self.get_policy_params()
        for i, r in enumerate(self.runners):
            self._inflight[r.sample.remote(host_params)] = i
        self._iter = 0
        self._returns = []

    def _apply_update(self, batch):
        """One fragment's learner step — the hook APPO swaps for the
        clipped-surrogate objective (same async pipeline)."""
        c = self.cfg
        return impala_update(
            self.policy, self.opt, batch, gamma=c.gamma,
            vf_coef=c.vf_coef, ent_coef=c.ent_coef, rho_bar=c.rho_bar,
            c_bar=c.c_bar)

    def train(self) -> dict:
        self._iter += 1
        consumed = 0
        stats = []
        sample_s = learn_s = 0.0
        while consumed < self.cfg.fragments_per_iter:
            t0 = time.perf_counter()
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight), num_returns=1, timeout=300)
            if not ready:
                raise TimeoutError("no rollout fragment within 300s")
            for ref in ready:
                idx = self._inflight.pop(ref)
                frag = ray_tpu_torch.get(ref, timeout=60)
                t1 = time.perf_counter()
                sample_s += t1 - t0
                stats.append(torch.stack(self._apply_update(
                    fragment_batch(frag, self.device))))
                if len(frag["episode_returns"]):
                    self._returns.extend(
                        frag["episode_returns"].tolist())
                    self._returns = self._returns[-100:]
                # re-dispatch the SAME runner with fresh weights —
                # the other runners' in-flight fragments stay stale
                # (V-trace corrects them on arrival)
                self._inflight[self.runners[idx].sample.remote(
                    self.get_policy_params())] = idx
                consumed += 1
                t0 = time.perf_counter()
                learn_s += t0 - t1
        losses, rhos = torch.stack(stats).cpu().numpy().T
        return {
            "training_iteration": self._iter,
            "episode_reward_mean": float(np.mean(self._returns))
            if self._returns else 0.0,
            "loss": float(np.mean(losses)),
            "mean_rho": float(np.mean(rhos)),
            "timesteps_this_iter": consumed
            * self.cfg.num_envs_per_runner * self.cfg.rollout_len,
            # waiting for fragments; updating and fetching the weights
            # that re-dispatch a runner
            "timers": {"sample_s": sample_s, "learn_s": learn_s},
        }

    def get_policy_params(self) -> dict:
        """The policy as the reference's numpy dict (``x @ W``)."""
        return rl_params_to_jax(self.policy)

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
