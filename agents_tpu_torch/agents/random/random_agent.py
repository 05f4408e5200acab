"""Trivial baseline agents.

Port of `RandomAgent`, `FixedPolicyAgent` and `TrivialAgentState` of
``agents_tpu/agents/random/random_agent.py``: `train` only counts its
steps (a host int) and returns a zero loss on the agent's device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from agents_tpu_torch.agents.agent import Agent
from agents_tpu_torch.policies.random_policy import RandomPolicy
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrivialAgentState:
  train_step: int


class FixedPolicyAgent(Agent):
  """Wraps any policy that needs no parameters as an agent."""

  def __init__(self, time_step_spec, action_spec, policy, device="cuda"):
    self.device = resolve_device(device)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.policy = policy
    self.collect_policy = policy
    self.train_sequence_length = None

  def init(self) -> TrivialAgentState:
    return TrivialAgentState(train_step=0)

  def policy_params(self, agent_state):
    return ()

  def train(self, agent_state, experience,
            weights=None) -> Tuple[TrivialAgentState, LossInfo]:
    del experience, weights
    return (TrivialAgentState(train_step=agent_state.train_step + 1),
            LossInfo(torch.zeros((), device=self.device), ()))


class RandomAgent(FixedPolicyAgent):
  """Acts uniformly at random."""

  def __init__(self, time_step_spec, action_spec, device="cuda"):
    super().__init__(time_step_spec, action_spec,
                     RandomPolicy(time_step_spec, action_spec), device=device)
