"""Agent base: train steps over explicit state.

Port of ``agents_tpu/agents/agent.py``:

    agent_state = agent.init()
    agent_state, loss_info = agent.train(agent_state, experience)
    step = agent.policy.action(agent.policy_params(agent_state), ...)

`experience` is a Trajectory nest shaped ``[B, T, ...]``. Unlike the JAX
package, `train` updates the parameter and optimizer tensors of
`agent_state` in place and returns a new state object that shares them.
"""
from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

from agents_tpu_torch.utils.common import LossInfo


def check_network_devices(device, **networks) -> None:
  """Raise unless every named network's parameters live on `device`'s
  type of device."""
  for name, net in networks.items():
    param_device = next(net.parameters()).device
    if param_device.type != device.type:
      raise ValueError(
          f"{name} lives on {param_device}, the agent on {device}")


class Agent(abc.ABC):
  """Base agent.

  Attributes (set by subclasses):
    time_step_spec / action_spec: environment interface specs.
    policy: eval/deployment policy.
    collect_policy: exploration policy.
    train_sequence_length: required T of training trajectories (or None).
  """

  time_step_spec = None
  action_spec = None
  policy = None
  collect_policy = None
  train_sequence_length: Optional[int] = None

  @abc.abstractmethod
  def init(self) -> Any:
    """Create the initial agent state."""

  @abc.abstractmethod
  def train(self, agent_state, experience) -> Tuple[Any, LossInfo]:
    """One gradient step; returns (new_state, LossInfo)."""

  def policy_params(self, agent_state):
    """Parameters consumed by `self.policy` (greedy/eval)."""
    return agent_state.params

  def collect_policy_params(self, agent_state):
    """Parameters consumed by `self.collect_policy`."""
    return self.policy_params(agent_state)
