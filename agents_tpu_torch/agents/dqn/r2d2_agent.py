"""R2D2: recurrent double Q-learning on stored-state sequences.

Kapturowski, Ostrovski, Quan, Munos, Dabney, "Recurrent Experience Replay
in Distributed Reinforcement Learning" (ICLR 2019), sections 2-3 and
Table 1. `R2d2Agent` is a `DdqnAgent` whose Q network is recurrent
(`networks.lstm_networks.RecurrentDuelingQModule`); it keeps DQN's
epsilon-greedy and greedy policies, spans, periodic target update and
eager train step, and replaces the loss:

  - a train step takes ``[B, T]`` windows of ``T = burn_in + L`` frames
    and the policy info stored with each frame: the carry ``(c, h)`` the
    collect network started that frame from, and the previous action and
    reward it read (`R2d2Policy`);
  - the online and the target network each unroll the first `burn_in`
    frames under `torch.no_grad` from the carry stored at the window's
    first frame (span ``agent.burn_in``), then the L trained frames from
    the carries they reached;
  - n-step double-Q targets under the value rescaling
    ``h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x``:
    ``y_t = h(sum_k c_k r_{t+k} + c_n' h^-1(Q_target(s_{t+n'},
    argmax_a Q_online(s_{t+n'}, a))))``, where the return stops at the
    first LAST frame s_{t+j} (j <= n): n' = j there, else n; c_k is the
    product of gamma times the frames' discounts before t+k;
  - the squared TD error ``(y_t - Q(s_t, a_t))^2`` over the valid trained
    positions (not LAST, and t + n inside the window: the last n trained
    positions have no bootstrap frame and are left out), the mean over a
    sequence's valid positions, weighted by the IS weights, then the mean
    over the batch;
  - per sequence the priority ``eta max_t |delta_t| + (1 - eta)
    mean_t |delta_t|`` over its valid positions, which the fused loop
    hands its prioritized replay (`LossInfo.extra.priority`).

A recurrent Q network has a `state_spec`, so the train step never runs as
a CUDA graph (`DqnAgent._graphable`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from agents_tpu_torch.agents.dqn.dqn_agent import DdqnAgent
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.policies.q_policy import QPolicy
from agents_tpu_torch.policies.wrappers import (EpsilonGreedyPolicy,
                                                GreedyPolicy)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import common, nest_utils, profiling

BURN_IN_SPAN = profiling.annotate("agent.burn_in")
# Table 1's: the eps of the value rescaling h, and the eta of the sequence
# priority.
VALUE_RESCALING_EPS = 1e-3
PRIORITY_ETA = 0.9


def value_rescale(x: torch.Tensor, eps: float) -> torch.Tensor:
  """h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x."""
  return torch.sign(x) * (torch.sqrt(x.abs() + 1) - 1) + eps * x


def inverse_value_rescale(x: torch.Tensor, eps: float) -> torch.Tensor:
  """h^-1(x) = sign(x)(((sqrt(1 + 4 eps (|x| + 1 + eps)) - 1) / (2 eps))^2
  - 1), written without the two cancellations of that form near 0: with
  r = sqrt((1 + 2 eps)^2 + 4 eps |x|) and d = (2|x| - 4 eps |x| / (1 +
  2 eps + r)) / (r + 1), the inner quotient is 1 + d and the result
  sign(x) d (2 + d)."""
  a = x.abs()
  r = torch.sqrt((1 + 2 * eps)**2 + 4 * eps * a)
  d = (2 * a - 4 * eps * a / (1 + 2 * eps + r)) / (r + 1)
  return torch.sign(x) * d * (2 + d)


@dataclasses.dataclass(frozen=True)
class R2d2LossExtra:
  td_loss: torch.Tensor    # [B, L] squared TD errors, 0 where not valid
  td_error: torch.Tensor   # [B, L] y - Q(s, a), 0 where not valid
  priority: torch.Tensor   # [B] eta max |td| + (1 - eta) mean |td|


def _network(params):
  """The Q network of a policy's params (a module, or the collect
  policy's {"q": module, "train_step": int})."""
  return params["q"] if isinstance(params, dict) else params


class _RecurrentQPolicy(QPolicy):
  """Q values of a `RecurrentDuelingQModule` at one step, its state
  ``(c, h, previous action)``; the previous reward is the time step's."""

  def __init__(self, time_step_spec, action_spec, q_network):
    super().__init__(time_step_spec, action_spec, q_network)
    action = nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec)[0]
    self.state_spec = tuple(q_network.state_spec) + (
        array_spec.ArraySpec((), action.dtype, "previous_action"),)

  def q_values(self, params, time_step, state=()):
    c, h, previous_action = state
    q, (c, h) = _network(params)(
        time_step.observation, time_step.step_type, (c, h),
        previous_action=previous_action,
        previous_reward=time_step.reward)
    return q, (c, h, previous_action)


class R2d2Policy(Policy):
  """A policy over `_RecurrentQPolicy` (greedy or epsilon-greedy) whose
  state carries the action it took as the next step's previous action,
  and whose info holds what the network read at the step besides the
  frame: the carry it started from (after the reset at FIRST) and the
  previous action and reward. The collect driver hands that info to the
  replay with each frame, which is how R2D2 stores its recurrent state."""

  def __init__(self, wrapped: Policy):
    c, h, previous_action = wrapped.state_spec
    info_spec = {"c": c, "h": h, "previous_action": previous_action,
                 "previous_reward": array_spec.ArraySpec(
                     (), np.float32, "previous_reward")}
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=info_spec, state_spec=wrapped.state_spec,
                     clip=wrapped.clip)
    self.wrapped = wrapped

  def _action(self, params, time_step, state, draws):
    step = self.wrapped._action(params, time_step, state, draws)
    c, h, previous_action = state
    info = {"c": c, "h": h, "previous_action": previous_action,
            "previous_reward": time_step.reward.to(torch.float32)}
    new_c, new_h, _ = step.state
    return step.replace(
        state=(new_c, new_h, step.action.to(previous_action.dtype)),
        info=info)

  def _distribution(self, params, time_step, state):
    return self.wrapped._distribution(params, time_step, state)


class R2d2Agent(DdqnAgent):
  """R2D2's learner (see the module docstring).

  Args:
    q_network: a `RecurrentDuelingQModule` on `device`.
    burn_in: frames unrolled without gradient before the trained ones.
    train_sequence_length: T, burn-in and trained frames together.
    n_step_update: n of the n-step targets.
    Others as `DqnAgent`'s; the TD loss is the squared error.
  """

  def __init__(self, time_step_spec, action_spec, q_network,
               optimizer_fn: Callable, epsilon_greedy=0.01,
               burn_in: int = 40, train_sequence_length: int = 120,
               n_step_update: int = 5, gamma: float = 0.997,
               target_update_tau: float = 1.0,
               target_update_period: int = 2500,
               gradient_clipping: Optional[float] = None, device="cuda"):
    if not q_network.state_spec:
      raise ValueError("R2d2Agent trains a recurrent Q network")
    if train_sequence_length - burn_in <= n_step_update:
      raise ValueError(
          f"{train_sequence_length - burn_in} trained frames leave no "
          f"position with its bootstrap frame {n_step_update} ahead")
    super().__init__(time_step_spec, action_spec, q_network, optimizer_fn,
                     epsilon_greedy=epsilon_greedy,
                     n_step_update=n_step_update,
                     td_errors_loss_fn=common.element_wise_squared_loss,
                     gamma=gamma, target_update_tau=target_update_tau,
                     target_update_period=target_update_period,
                     gradient_clipping=gradient_clipping,
                     train_sequence_length=train_sequence_length,
                     device=device)
    self.burn_in = int(burn_in)
    q_policy = _RecurrentQPolicy(time_step_spec, action_spec, q_network)
    self._q_policy = q_policy
    self.policy = R2d2Policy(GreedyPolicy(q_policy))
    eps = epsilon_greedy if callable(epsilon_greedy) \
        else lambda _: epsilon_greedy
    self.collect_policy = R2d2Policy(
        EpsilonGreedyPolicy(q_policy, lambda p: eps(p["train_step"])))

  def _unroll(self, network, experience, start, stop, state):
    info = experience.policy_info
    return network(experience.observation[:, start:stop],
                   experience.step_type[:, start:stop], state,
                   previous_action=info["previous_action"][:, start:stop],
                   previous_reward=info["previous_reward"][:, start:stop])

  def _loss(self, q_network, agent_state, experience, weights=None):
    """experience: Trajectory ``[B, T]`` windows with the stored policy
    info; returns (loss, R2d2LossExtra)."""
    target_network = agent_state.target_q_network
    info = experience.policy_info
    burn, steps = self.burn_in, experience.step_type.shape[1]
    online_state = target_state = (info["c"][:, 0], info["h"][:, 0])
    if burn:
      with BURN_IN_SPAN, torch.no_grad():
        _, online_state = self._unroll(q_network, experience, 0, burn,
                                       online_state)
        _, target_state = self._unroll(target_network, experience, 0, burn,
                                       target_state)
    q_all, _ = self._unroll(q_network, experience, burn, steps,
                            online_state)                     # [B, L, A]
    actions = experience.action[:, burn:]
    q_taken = common.index_with_actions(q_all, actions)      # [B, L]
    with torch.no_grad():
      target_all, _ = self._unroll(target_network, experience, burn, steps,
                                   target_state)
      best = torch.argmax(q_all.detach(), dim=-1)
      values = inverse_value_rescale(
          common.index_with_actions(target_all, best),
          VALUE_RESCALING_EPS)
      targets, valid = self._targets(experience, values)      # [B, M]
    length = steps - burn
    positions = targets.shape[1]
    td_error = (targets - q_taken[:, :positions]) * valid
    td_loss = self.td_errors_loss_fn(targets, q_taken[:, :positions]) * valid
    count = torch.clamp_min(valid.sum(dim=1), 1.0)
    per_sequence = td_loss.sum(dim=1) / count
    loss = common.aggregate_losses(per_example_loss=per_sequence,
                                   sample_weight=weights)
    magnitude = td_error.detach().abs()
    priority = (PRIORITY_ETA * magnitude.max(dim=1).values
                + (1 - PRIORITY_ETA) * magnitude.sum(dim=1) / count)
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x, (0, length - positions))
    return loss, R2d2LossExtra(td_loss=pad(td_loss), td_error=pad(td_error),
                               priority=priority)

  def _targets(self, experience, values):
    """(rescaled n-step targets, valid mask), each ``[B, M]`` over the
    first M = L - n trained positions; `values` ``[B, L]`` holds
    h^-1(Q_target(s, argmax Q_online(s))) of the trained frames."""
    burn, n = self.burn_in, self.n_step_update
    reward = experience.reward[:, burn:].float()
    discount = experience.discount[:, burn:].float()
    last = (experience.step_type[:, burn:] == ts.StepType.LAST).float()
    positions = reward.shape[1] - n
    window = lambda x, k: x[:, k:k + positions]  # noqa: E731
    returns = torch.zeros_like(window(reward, 0))
    bootstrap = torch.zeros_like(returns)
    coef = torch.ones_like(returns)       # gamma-discount before t+k, alive
    alive = torch.ones_like(returns)      # no LAST in t+1 .. t+k
    for k in range(n):
      returns = returns + coef * window(reward, k)
      coef = coef * self.gamma * window(discount, k)
      following = window(last, k + 1)
      stop = alive if k + 1 == n else alive * following
      bootstrap = bootstrap + stop * coef * window(values, k + 1)
      alive = alive * (1 - following)
      coef = coef * (1 - following)
    targets = value_rescale(returns + bootstrap, VALUE_RESCALING_EPS)
    return targets, 1 - window(last, 0)
