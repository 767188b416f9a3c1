"""The port's RLlib (``ray_tpu_torch.rllib``) held to the JAX package's
own RLlib tests, on the CPU.

``tests/test_rllib.py`` runs here unedited, with every ``ray_tpu`` name
rewritten to ``ray_tpu_torch`` (``_torch_ported.py``): each of its 12
tests is a test of the port under this file's id, with its assertions
and its time caps as they are.

The port's learners run on the card unless their config asks for the
CPU, and the reference tests build their configs without a device. So
the autouse fixture below asks for the CPU explicitly: it replaces each
``*Config`` of ``ray_tpu_torch.rllib``, and the ones the ported module
imported at its top, with a dataclass subclass whose ``device``
defaults to ``"cpu"``. The learners never pick the CPU on their own.
It also gives this process one intra-op thread while a test runs:
torch's default pool (a thread per core) spins between the learners'
small eager steps and takes the cores from the runner processes and
from the other test processes (under ``-n 4`` the PPO and DQN tests
took 48-49 s instead of 10-11).
"""

import dataclasses
from typing import Optional

import pytest
import torch

from _torch_ported import adopt, ported

import ray_tpu_torch.rllib as rllib

REF = ported("test_rllib")
adopt(REF, globals())

CONFIGS = ("PPOConfig", "IMPALAConfig", "APPOConfig", "DQNConfig",
           "SACConfig", "BCConfig", "MultiAgentPPOConfig")


def on_cpu(cls):
    """``cls`` with ``device`` defaulting to ``"cpu"``."""
    return dataclasses.make_dataclass(
        cls.__name__, [("device", Optional[str], "cpu")], bases=(cls,))


@pytest.fixture(autouse=True)
def learners_on_cpu(monkeypatch):
    for name in CONFIGS:
        cpu = on_cpu(getattr(rllib, name))
        monkeypatch.setattr(rllib, name, cpu)
        if name in vars(REF):
            monkeypatch.setattr(REF, name, cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
