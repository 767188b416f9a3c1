"""RL layer: parallel rollout actors + learners on the card.

Analog of the reference's RLlib core loop (reference: python/ray/rllib/
algorithms/algorithm.py train() driving env_runner_group + learner_group)
covering both halves of the algorithm matrix: on-policy (PPO) and
off-policy with a replay-buffer actor (DQN).

The port of ``ray_tpu/rllib``: each learner's networks and optimizer
state live on its config's ``device`` (None is the card, and raises
without one); the env runners and the replay buffer are CPU processes
of the port's runtime, as the reference pins them to the host.
"""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bc import BC, BCConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.env import (CartPoleVec, MultiCartPoleVec,
                                     PendulumVec, make_env)
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.multi_agent import (MultiAgentPPO,
                                             MultiAgentPPOConfig,
                                             make_multi_agent_env)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = ["APPO", "APPOConfig", "BC", "BCConfig", "DQN", "DQNConfig",
           "IMPALA", "IMPALAConfig", "MultiAgentPPO",
           "MultiAgentPPOConfig", "PPO", "PPOConfig", "SAC",
           "SACConfig", "ReplayBuffer", "CartPoleVec",
           "MultiCartPoleVec", "PendulumVec", "make_env",
           "make_multi_agent_env"]
