"""Behavioural cloning.

Port of `BehavioralCloningAgent` and `BcAgentState` of
``agents_tpu/agents/behavioral_cloning/behavioral_cloning_agent.py``
(:26-106): a supervised loss on the experience's actions, with any
``[B, T]`` outer dims flattened into frames:

  - an actor-distribution network is scored by ``-log pi(a | s)``
    (`common.log_probability` over the distribution nest); its collect
    policy is `ActorPolicy`, its eval policy the greedy one;
  - a Q (logits) network by the cross-entropy of ``log_softmax`` with the
    integer actions as labels; the action spec's minimum must be 0 (the
    labels index the logits), else the constructor raises. Its collect
    policy is epsilon-greedy at 0.1 over `QPolicy`.

One optimizer over the network, optional global-norm clipping; the train
step is a host int.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.agents.agent import Agent, check_network_devices
from agents_tpu_torch.policies.actor_policy import ActorPolicy
from agents_tpu_torch.policies.q_policy import QPolicy
from agents_tpu_torch.policies.wrappers import EpsilonGreedyPolicy, GreedyPolicy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import common, nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BcAgentState:
  network: nn.Module
  optimizer: torch.optim.Optimizer
  train_step: int


class BehavioralCloningAgent(Agent):
  """Args:
    network: an actor-distribution network, or with
      ``network_is_distribution=False`` a Q network over discrete actions.
    optimizer_fn: builds an optimizer from a list of parameters.
    device: where the network lives; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, network: nn.Module,
               optimizer_fn: Callable, network_is_distribution: bool = True,
               gradient_clipping: Optional[float] = None, device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, network=network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.network = network
    self.optimizer_fn = optimizer_fn
    self.network_is_distribution = network_is_distribution
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = None   # any [B, T]
    if network_is_distribution:
      self.collect_policy = ActorPolicy(time_step_spec, action_spec, network)
      self.policy = GreedyPolicy(self.collect_policy)
    else:
      for s in nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec):
        if int(np.min(s.minimum)) != 0:
          raise ValueError(
              "BehavioralCloningAgent with a logits network requires action "
              f"spec minimum 0, got {s}")
      q_policy = QPolicy(time_step_spec, action_spec, network)
      self.policy = GreedyPolicy(q_policy)
      self.collect_policy = EpsilonGreedyPolicy(q_policy, 0.1)

  def init(self) -> BcAgentState:
    return BcAgentState(network=self.network,
                        optimizer=self.optimizer_fn(
                            list(self.network.parameters())),
                        train_step=0)

  def policy_params(self, agent_state: BcAgentState):
    return agent_state.network

  def loss(self, agent_state: BcAgentState, experience, weights=None):
    """The mean negative log-likelihood (or cross-entropy) of the
    experience's actions, its outer dims flattened."""
    outer = experience.step_type.dim()
    flat = lambda nest: nest_utils.tree_map(  # noqa: E731
        lambda t: t.reshape((-1,) + tuple(t.shape[outer:])), nest)
    out, _ = agent_state.network(flat(experience.observation),
                                 flat(experience.step_type), ())
    actions = flat(experience.action)
    if self.network_is_distribution:
      per_example = -common.log_probability(out, actions)
    else:
      per_example = -torch.gather(torch.log_softmax(out, -1), -1,
                                  actions.long().unsqueeze(-1)).squeeze(-1)
    return common.aggregate_losses(per_example_loss=per_example,
                                   sample_weight=weights)

  def train(self, agent_state: BcAgentState, experience,
            weights=None) -> Tuple[BcAgentState, LossInfo]:
    s = agent_state
    loss = self.loss(s, experience, weights)
    params = list(s.network.parameters())
    grads = torch.autograd.grad(loss, params)
    if self.gradient_clipping is not None:
      common.clip_gradient_norms(grads, self.gradient_clipping)
    for p, g in zip(params, grads):
      p.grad = g
    s.optimizer.step()
    return (dataclasses.replace(s, train_step=s.train_step + 1),
            LossInfo(loss.detach(), ()))
