"""Agent base: train steps over explicit state.

Port of ``agents_tpu/agents/agent.py``:

    agent_state = agent.init()
    agent_state, loss_info = agent.train(agent_state, experience)
    step = agent.policy.action(agent.policy_params(agent_state), ...)

`experience` is a Trajectory nest shaped ``[B, T, ...]``. Unlike the JAX
package, `train` updates the parameter and optimizer tensors of
`agent_state` in place and returns a new state object that shares them.

Data parallelism: a loop built with a mesh (`parallel.create_mesh`) sets
the agent's `mesh`, and every train step's `apply_gradients` then
averages the gradients over the mesh's ranks before clipping and the
optimizer step, the all-reduce the JAX package's partitioner inserts.
Each rank trains on an equal share of the global batch, so the average
is the global batch's gradient.
"""
from __future__ import annotations

import abc
import copy
from typing import Any, Optional, Tuple

import torch

from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, nest_utils, profiling
from agents_tpu_torch.utils.common import LossInfo

# A train step's spans (`utils/profiling.py`), opened by the agents' `train`:
# the losses' forward, `torch.autograd.grad`, and `apply_gradients` with the
# periodic target update.
LOSS_SPAN = profiling.annotate("agent.loss")
GRAD_SPAN = profiling.annotate("agent.grad")
APPLY_SPAN = profiling.annotate("agent.apply")


def check_network_devices(device, **networks) -> None:
  """Raise unless every named network's parameters live on `device`'s
  type of device."""
  for name, net in networks.items():
    param_device = next(net.parameters()).device
    if param_device.type != device.type:
      raise ValueError(
          f"{name} lives on {param_device}, the agent on {device}")


def first_transition(experience, agent_name: str):
  """(time steps, actions, next time steps) of a ``[B, 2]`` experience of
  adjacent frames."""
  tj.check_adjacent_transition_sequence(experience, agent_name)
  transition = tj.to_transition(experience)
  first = lambda x: x[:, 0]  # noqa: E731
  return (nest_utils.tree_map(first, transition.time_step),
          nest_utils.tree_map(first, transition.action_step.action),
          nest_utils.tree_map(first, transition.next_time_step))


def average_gradients(grads, mesh) -> None:
  """Replace each gradient by its mean over `mesh`'s ranks, in place, with
  one all-reduce of the flattened gradients."""
  if mesh is None or not mesh.distributed:
    return
  grads = [g for g in grads if g is not None]
  flat = torch.cat([g.reshape(-1) for g in grads])
  mesh.all_reduce(flat).div_(mesh.size)
  offset = 0
  for g in grads:
    g.copy_(flat[offset:offset + g.numel()].view_as(g))
    offset += g.numel()


def apply_gradients(groups, gradient_clipping: Optional[float],
                    mesh=None) -> None:
  """For each (gradients, parameters, optimizer): average the gradients
  over `mesh` (a data-parallel group, or None), clip their global norm if
  asked, set them and step the optimizer. Callers take every group's
  gradients first, so no loss reads a stepped parameter."""
  for grads, params, optimizer in groups:
    average_gradients(grads, mesh)
    if gradient_clipping is not None:
      common.clip_gradient_norms(grads, gradient_clipping)
    for p, g in zip(params, grads):
      p.grad = g
    optimizer.step()


class Agent(abc.ABC):
  """Base agent.

  Attributes (set by subclasses):
    time_step_spec / action_spec: environment interface specs.
    policy: eval/deployment policy.
    collect_policy: exploration policy.
    train_sequence_length: required T of training trajectories (or None).
    mesh: the data-parallel group its train steps average gradients
      over, or None; set by a loop built with a mesh.
  """

  time_step_spec = None
  action_spec = None
  policy = None
  collect_policy = None
  train_sequence_length: Optional[int] = None
  mesh = None

  @abc.abstractmethod
  def init(self) -> Any:
    """Create the initial agent state."""

  @abc.abstractmethod
  def train(self, agent_state, experience) -> Tuple[Any, LossInfo]:
    """One gradient step; returns (new_state, LossInfo)."""

  def loss(self, agent_state, experience) -> LossInfo:
    """The LossInfo of a train step, applying no gradient: the step runs
    on a deep copy of `agent_state` (its networks, optimizers and draw
    source), so `agent_state` is left as it was, as the JAX package's
    pure `train` leaves it, and the train step after this loss draws
    what it drew."""
    _, info = self.train(copy.deepcopy(agent_state), experience)
    return info

  def preprocess_sequence(self, agent_state, experience):
    """Experience preprocessing hook; the identity by default."""
    del agent_state
    return experience

  def policy_params(self, agent_state):
    """Parameters consumed by `self.policy` (greedy/eval)."""
    return agent_state.params

  def collect_policy_params(self, agent_state):
    """Parameters consumed by `self.collect_policy`."""
    return self.policy_params(agent_state)
