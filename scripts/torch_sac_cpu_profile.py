"""Profile the port's SAC minibatch step on the CPU.

``ray_tpu_torch.rllib.sac.sac_update`` over K minibatches at the SAC
reference test's shapes (Pendulum: obs 3, action 1; batch 128; hidden
(64, 64); lr 1e-3), with the learner on the CPU: the host wall per
minibatch step (unprofiled, after a warm-up call), then one profiled
call under ``torch.profiler``: aten operator calls per step at every
level and at the top level (issued by Python or the autograd engine, not
nested in another aten op), and the mean host microseconds of a
top-level op.

    python scripts/torch_sac_cpu_profile.py [--threads N] [--k K]
"""

import argparse
import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ray_tpu_torch.rllib import sac  # noqa: E402
from ray_tpu_torch.rllib.nets import adam  # noqa: E402


def _top_level(e) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return e.name.startswith("aten::")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--k", type=int, default=40,
                    help="minibatches per sac_update call")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    gen = torch.Generator().manual_seed(0)
    obs_dim, act_dim, b, k = 3, 1, 128, args.k
    actor = sac.init_actor(gen, obs_dim, act_dim, (64, 64))
    critic = sac.init_critic(gen, obs_dim, act_dim, (64, 64))
    target = copy.deepcopy(critic).requires_grad_(False)
    log_alpha = torch.tensor(np.log(0.1), dtype=torch.float32,
                             requires_grad=True)
    opts = (adam(actor.parameters(), 1e-3), adam(critic.parameters(), 1e-3),
            adam([log_alpha], 1e-3))
    rng = np.random.default_rng(0)

    def arr(*shape, lo=None):
        a = rng.uniform(-2, 2, shape) if lo else rng.normal(size=shape)
        return torch.from_numpy(a.astype(np.float32))
    batches = {"obs": arr(k, b, obs_dim), "next_obs": arr(k, b, obs_dim),
               "actions": arr(k, b, act_dim, lo=True),
               "rewards": arr(k, b), "dones": torch.zeros(k, b)}
    noise = torch.randn((k, 2, b, act_dim), generator=gen)
    kw = dict(gamma=0.99, tau=0.005, action_high=2.0, target_entropy=-1.0)

    def step():
        sac.sac_update(actor, critic, target, log_alpha, opts, batches,
                       noise, **kw)
    step()
    t0 = time.perf_counter()
    step()
    wall_us = (time.perf_counter() - t0) / k * 1e6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    evs = prof.events()
    every = sum(1 for e in evs if e.name.startswith("aten::"))
    top = [e for e in evs if _top_level(e)]
    top_us = sum(e.cpu_time_total for e in top)
    print(f"threads {args.threads}, {k} minibatches of {b}: host wall per "
          f"minibatch step {wall_us:.1f} us (unprofiled); aten op calls "
          f"per step {every / k:.1f} at every level, {len(top) / k:.1f} at "
          f"the top level; mean top-level op {top_us / len(top):.2f} us "
          f"(profiled)")


if __name__ == "__main__":
    main()
