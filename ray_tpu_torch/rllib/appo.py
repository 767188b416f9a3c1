"""APPO: asynchronous PPO — IMPALA's actor-learner pipeline with the
PPO clipped surrogate on V-trace-corrected advantages.

Reference: python/ray/rllib/algorithms/appo/appo.py (APPO = IMPALA-style
async sampling + V-trace off-policy correction + PPO's ratio clip,
per "IMPACT", Luo et al. 2020). The shape is IMPALA's: runners sample
with the weights they were last handed, the learner drains ready
fragments and re-dispatches — but the policy loss clips the importance
ratio instead of multiplying it in, which tolerates the staleness a busy
pipeline accumulates better than raw V-trace PG.

Deliberate scope cut vs the reference: no separate target network /
KL-coeff adaption — the clip is the stabilizer (the reference's own
default path; target-net mixing is an option there).

The port of ``ray_tpu/rllib/appo.py``; the learner runs where IMPALA's
does (``APPOConfig.device``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, _vtrace_terms
from ray_tpu_torch.rllib.nets import Adam
from ray_tpu_torch.rllib.ppo import _entropy


def appo_update(policy, opt: Adam, batch: dict, *,
                gamma: float = 0.99, clip: float = 0.3,
                vf_coef: float = 0.5, ent_coef: float = 0.01,
                rho_bar: float = 1.0, c_bar: float = 1.0):
    """One fragment's clipped-surrogate update on V-trace targets, in
    place. batch: obs (T, N, D), actions / behavior_logp / rewards /
    dones (T, N), last_obs (N, D). Returns (loss, mean ratio) as device
    scalars."""
    logits, values, target_logp, vs, pg_adv = _vtrace_terms(
        policy, batch, gamma, rho_bar, c_bar)
    # raw V-trace advantages, like IMPALA: per-fragment mean/std
    # normalization is noisy at (T*N)~512 and washed out the
    # baseline signal in practice.
    # PPO surrogate against the BEHAVIOR policy (the off-policy
    # ratio the clip bounds is exactly the staleness ratio)
    ratio = torch.exp(target_logp - batch["behavior_logp"])
    pi_loss = -torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1 - clip, 1 + clip) * pg_adv).mean()
    v_loss = ((values - vs) ** 2).mean()
    loss = pi_loss + vf_coef * v_loss - ent_coef * _entropy(logits)
    opt.minimize(loss)
    return loss.detach(), ratio.detach().mean()


@dataclass
class APPOConfig(IMPALAConfig):
    lr: float = 1e-3
    clip: float = 0.3


class APPO(IMPALA):
    """Async PPO: IMPALA's pipeline, PPO's objective."""

    def _apply_update(self, batch):
        c = self.cfg
        return appo_update(
            self.policy, self.opt, batch, gamma=c.gamma, clip=c.clip,
            vf_coef=c.vf_coef, ent_coef=c.ent_coef, rho_bar=c.rho_bar,
            c_bar=c.c_bar)
