"""REINFORCE.

Port of `ReinforceAgent`, `ReinforceAgentState` and `ReinforceLossExtra` of
``agents_tpu/agents/reinforce/reinforce_agent.py`` (:24-158): Monte-Carlo
returns with the discount zeroed at every episode-final transition; the
frames after each row's last completed episode masked out (a reverse
cumulative sum of `is_last`, written with `torch.flip`); the losses
normalized by the number of completed episodes; an optional value-network
baseline and entropy bonus. One optimizer step over the actor's, then the
value network's parameters per `train` call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from agents_tpu_torch.agents.agent import Agent, check_network_devices
from agents_tpu_torch.policies.actor_policy import ActorPolicy
from agents_tpu_torch.policies.wrappers import GreedyPolicy
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import common, nest_utils, value_ops
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ReinforceAgentState:
  actor_network: nn.Module
  value_network: Optional[nn.Module]
  optimizer: torch.optim.Optimizer   # over the actor's, then the value's
  train_step: int


@dataclasses.dataclass(frozen=True)
class ReinforceLossExtra:
  policy_gradient_loss: torch.Tensor
  value_estimation_loss: torch.Tensor


class ReinforceAgent(Agent):
  """REINFORCE over an actor network and an optional value baseline.

  Args:
    optimizer_fn: builds the optimizer from the list of the actor's, then
      the value network's parameters.
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, actor_network: nn.Module,
               optimizer_fn: Callable, value_network: Optional[nn.Module] = None,
               value_estimation_loss_coef: float = 0.2, gamma: float = 1.0,
               normalize_returns: bool = True,
               entropy_regularization: Optional[float] = None,
               gradient_clipping: Optional[float] = None, device="cuda"):
    self.device = resolve_device(device)
    networks = {"actor_network": actor_network}
    if value_network is not None:
      networks["value_network"] = value_network
    check_network_devices(self.device, **networks)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.actor_network = actor_network
    self.value_network = value_network
    self.optimizer_fn = optimizer_fn
    self.value_estimation_loss_coef = value_estimation_loss_coef
    self.gamma = gamma
    self.normalize_returns = normalize_returns
    self.entropy_regularization = entropy_regularization
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = None  # full episodes [B, T]

    self.collect_policy = ActorPolicy(time_step_spec, action_spec,
                                      actor_network)
    self.policy = GreedyPolicy(self.collect_policy)

  def init(self) -> ReinforceAgentState:
    params = list(self.actor_network.parameters())
    if self.value_network is not None:
      params += list(self.value_network.parameters())
    return ReinforceAgentState(
        actor_network=self.actor_network, value_network=self.value_network,
        optimizer=self.optimizer_fn(params), train_step=0)

  def policy_params(self, agent_state: ReinforceAgentState):
    return agent_state.actor_network

  def _loss(self, agent_state: ReinforceAgentState, experience, returns,
            mask):
    b, t = mask.shape
    flat = lambda x: nest_utils.tree_map(  # noqa: E731
        lambda v: v.reshape((b * t,) + tuple(v.shape[2:])), x)
    obs, step_type = flat(experience.observation), flat(experience.step_type)
    dist, _ = agent_state.actor_network(obs, step_type, ())
    log_prob = common.log_probability(dist, flat(experience.action)).reshape(
        b, t)

    # Normalized by the number of COMPLETE episodes.
    num_episodes = torch.clamp(torch.sum(
        (experience.next_step_type == ts.StepType.LAST).float()), min=1.0)

    advantage = returns
    value_loss = torch.zeros((), device=mask.device)
    if agent_state.value_network is not None:
      values, _ = agent_state.value_network(obs, step_type, ())
      values = values.reshape(b, t)
      advantage = returns - values.detach()
      value_loss = self.value_estimation_loss_coef * torch.sum(
          torch.square(returns - values) * mask) / num_episodes

    if self.normalize_returns:
      denom = torch.clamp(mask.sum(), min=1.0)
      mean = torch.sum(advantage * mask) / denom
      var = torch.sum(torch.square(advantage - mean) * mask) / denom
      advantage = (advantage - mean) / (torch.sqrt(var) + 1e-6)

    pg_loss = -torch.sum(log_prob * advantage * mask) / num_episodes

    total = pg_loss + value_loss
    if self.entropy_regularization:
      entropy = common.entropy(dist).reshape(b, t)
      total = total - self.entropy_regularization * torch.sum(
          entropy * mask) / num_episodes
    return total, ReinforceLossExtra(policy_gradient_loss=pg_loss,
                                     value_estimation_loss=value_loss)

  def train(self, agent_state: ReinforceAgentState, experience, weights=None,
            draws=None) -> Tuple[ReinforceAgentState, LossInfo]:
    """experience: Trajectory [B, T] of (ideally whole) episodes."""
    del weights, draws
    with torch.no_grad():
      # The discount is zeroed at episode-final transitions, so the returns
      # restart there even when a time limit keeps the discount at 1.
      is_last = (experience.next_step_type == ts.StepType.LAST).to(
          experience.discount.dtype)
      discounts = experience.discount * self.gamma * (1.0 - is_last)
      returns = value_ops.discounted_return(
          experience.reward.transpose(0, 1),
          discounts.transpose(0, 1)).transpose(0, 1)
      mask = (experience.step_type != ts.StepType.LAST).float()
      # Frames after each row's last completed episode weigh nothing: their
      # returns are cut at the window's edge with no bootstrap.
      remaining_lasts = torch.flip(
          torch.cumsum(torch.flip(is_last.float(), [1]), dim=1), [1])
      mask = mask * (remaining_lasts > 0).float()

    loss, extra = self._loss(agent_state, experience, returns, mask)
    params = [p for group in agent_state.optimizer.param_groups
              for p in group["params"]]
    grads = torch.autograd.grad(loss, params)
    if self.gradient_clipping is not None:
      common.clip_gradient_norms(grads, self.gradient_clipping)
    for p, g in zip(params, grads):
      p.grad = g
    agent_state.optimizer.step()
    extra = ReinforceLossExtra(
        policy_gradient_loss=extra.policy_gradient_loss.detach(),
        value_estimation_loss=extra.value_estimation_loss.detach())
    return (dataclasses.replace(agent_state,
                                train_step=agent_state.train_step + 1),
            LossInfo(loss=loss.detach(), extra=extra))
