"""PPO on PyTorch over runtime rollout actors.

The minimal algorithm slice of the reference's RL layer (reference:
python/ray/rllib/algorithms/ppo/ppo.py + env_runner_group: N rollout
workers as actors collect batches in parallel, a learner applies
clipped-surrogate updates, weights broadcast each iteration).

The port of ``ray_tpu/rllib/ppo.py``. The learner's policy and Adam
state live on ``PPOConfig.device`` (None is the card, and raises without
one); GAE and the epoch loop run there as eager ops, and the loss is
read back once per ``train()``. Rollout actors keep a CPU copy of the
policy, as the reference pins its runners to the host CPU: their policy
steps are tiny batches issued one at a time. Weights cross to them as
the reference's numpy dicts (``bridge.rl_params_to_jax``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.bridge import rl_params_from_jax, rl_params_to_jax
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.nets import Adam, Net, adam, to_device


# --- policy -------------------------------------------------------------

class Policy(Net):
    """Trunk + policy head ``pi`` (init 0.01) + value head ``v`` (1.0)."""

    def __init__(self, generator: torch.Generator, obs_dim: int,
                 n_actions: int, hidden: Sequence[int] = (64, 64)):
        super().__init__(generator, (obs_dim, *hidden),
                         {"pi": (n_actions, 0.01), "v": (1, 1.0)})

    def forward(self, obs: torch.Tensor):
        """obs (B, obs_dim) -> (logits (B, A), value (B,))."""
        x = self.features(obs)
        return self.heads["pi"](x), self.heads["v"](x)[:, 0]


def init_policy(generator: torch.Generator, obs_dim: int, n_actions: int,
                hidden=(64, 64)) -> Policy:
    """A CPU ``Policy`` drawn from ``generator``; move it with ``.to``."""
    return Policy(generator, obs_dim, n_actions, hidden)


def policy_forward(policy: Policy, obs: torch.Tensor):
    """obs (B, obs_dim) -> (logits (B, A), value (B,))."""
    return policy(obs)


# --- rollout actor ------------------------------------------------------

def pin_runner_threads() -> None:
    """One intra-op thread for the calling thread of a rollout process.
    A runner's policy steps are (num_envs, 64) matmuls, too small to
    share, and torch's default pool (one thread per core) in every runner
    beside the learner oversubscribes the host: MKL's threads spin
    between the steps. MKL keeps its thread count per calling thread, and
    the runtime runs an actor's calls on executor threads, so each
    runner calls this at the start of every call that computes."""
    torch.set_num_threads(1)


@torch.no_grad()
def act(policy: Policy, obs: np.ndarray, generator: torch.Generator):
    """The runner's policy step on the CPU: a categorical draw from
    ``generator`` over softmax(logits), the log-prob of the drawn action
    and the value, as numpy (actions int32, as the reference's)."""
    logits, value = policy(torch.from_numpy(obs))
    logp_all = F.log_softmax(logits, dim=-1)
    a = torch.multinomial(logp_all.exp(), 1, generator=generator)
    logp = logp_all.gather(1, a)[:, 0]
    return a[:, 0].to(torch.int32).numpy(), logp.numpy(), value.numpy()


@ray_tpu_torch.remote
class EnvRunner:
    """Collects fixed-length rollout fragments with the current policy
    (reference: rllib/env/single_agent_env_runner.py sample())."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 seed: int, hidden=(64, 64)):
        pin_runner_threads()
        self.env = make_env(env_name, num_envs, seed)
        self.rollout_len = rollout_len
        self.obs = self.env.reset_all()
        self.gen = torch.Generator().manual_seed(seed)
        self.ep_ret = np.zeros(num_envs, np.float32)
        self.done_returns = deque(maxlen=100)
        self.policy = init_policy(torch.Generator(), self.env.OBS_DIM,
                                  self.env.N_ACTIONS, hidden)

    def sample(self, params: dict) -> Dict[str, np.ndarray]:
        pin_runner_threads()
        rl_params_from_jax(params, self.policy)
        out = {k: [] for k in
               ("obs", "actions", "logp", "rewards", "dones", "values")}
        for _ in range(self.rollout_len):
            a, logp, v = act(self.policy, self.obs, self.gen)
            obs2, r, done = self.env.step(a)
            out["obs"].append(self.obs)
            out["actions"].append(a)
            out["logp"].append(logp)
            out["values"].append(v)
            out["rewards"].append(r)
            out["dones"].append(done.astype(np.float32))
            self.ep_ret += r
            if done.any():
                for i in np.where(done)[0]:
                    self.done_returns.append(float(self.ep_ret[i]))
                    self.ep_ret[i] = 0.0
            self.obs = obs2
        with torch.no_grad():
            _, last_v = self.policy(torch.from_numpy(self.obs))
        batch = {k: np.stack(v) for k, v in out.items()}  # (T, N, ...)
        batch["last_value"] = last_v.numpy()              # (N,)
        # final observation: off-policy learners (IMPALA) bootstrap
        # from it under the CURRENT params instead of trusting last_value
        batch["last_obs"] = np.asarray(self.obs)          # (N, D)
        batch["episode_returns"] = np.array(
            self.done_returns, np.float32)
        return batch


# --- learner ------------------------------------------------------------

def _gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """GAE over (T, N) tensors on their device, a reverse loop over T
    (one fused multiply-add a step). Returns (advantages, returns)."""
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    not_done = 1 - dones
    deltas = rewards + gamma * v_next * not_done - values
    coef = gamma * lam * not_done
    advs = torch.empty_like(rewards)
    adv = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = torch.addcmul(deltas[t], coef[t], adv, out=advs[t])
    return advs, advs + values


def _entropy(logits: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return -(probs * torch.log(probs + 1e-9)).sum(-1).mean()


def ppo_update(policy: Policy, opt: Adam, batch: dict,
               perms: torch.Tensor, *, clip: float = 0.2,
               minibatches: int = 4, vf_coef: float = 0.5,
               ent_coef: float = 0.01) -> torch.Tensor:
    """``perms.shape[0]`` epochs of ``minibatches`` Adam steps each, in
    place on ``policy`` and ``opt``. ``batch``: obs (T, N, D), actions /
    logp / advantages / returns (T, N), on the policy's device; ``perms``
    (epochs, T * N): each epoch's row permutation. Advantages are
    normalised by their population std (``jnp.std``). Returns the mean
    loss as a device scalar."""
    obs = batch["obs"].reshape(-1, batch["obs"].shape[-1])
    acts = batch["actions"].reshape(-1).long()
    logp_old = batch["logp"].reshape(-1)
    advs = batch["advantages"].reshape(-1)
    rets = batch["returns"].reshape(-1)
    advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    mb = obs.shape[0] // minibatches
    losses = []
    for perm in perms:
        for i in range(minibatches):
            idx = perm[i * mb:(i + 1) * mb]
            logits, value = policy(obs[idx])
            logp = F.log_softmax(logits, dim=-1).gather(
                1, acts[idx, None])[:, 0]
            ratio = torch.exp(logp - logp_old[idx])
            a = advs[idx]
            pi_loss = -torch.minimum(
                ratio * a, torch.clamp(ratio, 1 - clip, 1 + clip) * a
            ).mean()
            v_loss = ((value - rets[idx]) ** 2).mean()
            loss = pi_loss + vf_coef * v_loss - ent_coef * _entropy(logits)
            opt.minimize(loss)
            losses.append(loss.detach())
    return torch.stack(losses).mean()


def draw_perms(generator: torch.Generator, epochs: int, n: int
               ) -> torch.Tensor:
    """(epochs, n) row permutations from a CPU generator: the draws
    ``ppo_update`` takes, the same on every device."""
    return torch.stack([torch.randperm(n, generator=generator)
                        for _ in range(epochs)])


def concat_fragments(frags) -> dict:
    """Runner fragments pooled along the env axis (axis 1), and their
    ``last_value``s along axis 0, in the fragments' order."""
    cat = {k: np.concatenate([f[k] for f in frags], axis=1) for k in
           ("obs", "actions", "logp", "rewards", "dones", "values")}
    cat["last_value"] = np.concatenate([f["last_value"] for f in frags])
    return cat


def gae_batch(cat: dict, device: torch.device, gamma: float, lam: float
              ) -> dict:
    """Pooled host fragments -> ``ppo_update``'s batch on ``device``."""
    t = {k: to_device(v, device) for k, v in cat.items()}
    advs, rets = _gae(t["rewards"], t["values"], t["dones"],
                      t["last_value"], gamma, lam)
    return {"obs": t["obs"], "actions": t["actions"], "logp": t["logp"],
            "advantages": advs, "returns": rets}


@dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_len: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 4
    minibatches: int = 4
    hidden: tuple = (64, 64)
    seed: int = 0
    runner_options: dict = field(default_factory=dict)
    # the learner's device: None is the card (raises without one)
    device: Optional[str] = None


class PPO:
    def __init__(self, config: PPOConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        env = make_env(config.env, 1, 0)
        self.obs_dim, self.n_actions = env.OBS_DIM, env.N_ACTIONS
        self.policy = init_policy(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.n_actions, config.hidden).to(self.device)
        self.opt = adam(self.policy.parameters(), config.lr)
        self.gen = torch.Generator().manual_seed(config.seed + 1)
        self.runners = [
            EnvRunner.options(**config.runner_options).remote(
                config.env, config.num_envs_per_runner,
                config.rollout_len, config.seed + 100 + i, config.hidden)
            for i in range(config.num_env_runners)]
        self._iter = 0

    def train(self) -> dict:
        """One iteration: parallel rollouts -> GAE -> PPO epochs.
        ``timers``: the seconds spent waiting for the runners' fragments
        and in the learner (the update read back once, at its end)."""
        c = self.cfg
        self._iter += 1
        t0 = time.perf_counter()
        host_params = self.get_policy_params()
        batches = ray_tpu_torch.get(
            [r.sample.remote(host_params) for r in self.runners],
            timeout=300)
        t1 = time.perf_counter()
        batch = gae_batch(concat_fragments(batches), self.device,
                          c.gamma, c.lam)
        perms = draw_perms(self.gen, c.epochs,
                           batch["obs"].shape[0] * batch["obs"].shape[1])
        loss = ppo_update(self.policy, self.opt, batch,
                          perms.to(self.device), clip=c.clip,
                          minibatches=c.minibatches).item()
        t2 = time.perf_counter()
        ep = np.concatenate([b["episode_returns"] for b in batches]) \
            if any(len(b["episode_returns"]) for b in batches) \
            else np.array([0.0])
        return {"training_iteration": self._iter,
                "episode_reward_mean": float(ep.mean()),
                "loss": loss,
                "timesteps_this_iter": int(
                    c.num_env_runners * c.num_envs_per_runner
                    * c.rollout_len),
                "timers": {"sample_s": t1 - t0, "learn_s": t2 - t1}}

    def get_policy_params(self) -> dict:
        """The policy as the reference's numpy dict (``x @ W``)."""
        return rl_params_to_jax(self.policy)
