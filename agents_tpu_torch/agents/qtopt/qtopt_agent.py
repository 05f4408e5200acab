"""QtOpt: Q-learning with a cross-entropy-method action optimizer.

Port of `QtOptAgent`, `QtOptAgentState` and `QtOptLossExtra` of
``agents_tpu/agents/qtopt/qtopt_agent.py`` (:42-195). The TD target's
next action is CEM's argmax over the target critic:
  - with `enable_td3` (the default) the target is clipped double Q,
    ``min(Q_delayed, Q_delayed_2)`` scored at the target critic's CEM
    action, over two delayed targets (:125-141);
  - the update chain after each step keeps the reference's order: every
    `delayed_target_update_period` steps ``delayed_2 <- old delayed``, then
    ``delayed <- old target``; then ``target <- q`` by a polyak update
    every `target_update_period` steps (:177-191);
  - n-step targets through `to_n_step_transition`, boundary transitions
    masked (``~is_last``), `reward_scale_factor` and optional global-norm
    `gradient_clipping`;
  - ``in_graph_bellman_update=False`` reads the next Q from the
    trajectory's ``policy_info["target_q"]`` (or ``.target_q``) instead of
    running CEM (:128-132);
  - the collect policy is epsilon-greedy over CEM, or Gaussian noise over
    CEM with `exploration_noise_std`; both policies act with CEM over the
    target critic (`policy_params`, :115-118).

The train step's CEM draws come from the agent state's draw source
(``Draws(53, device)`` unless `init` is given one) at "cem_normal"; the JAX
package derives its key as ``fold_in(key(53), train_step)`` (:166-167).
The train step is a host int, so the periodic updates need no device
`where` and no sync.

Beyond the JAX package: `cem_sampler` picks CEM's sampler (QT-Opt's
grasping action is a continuous and a one-hot part,
`GaussianOneHotSampler` under a `ConcatenatedSampler`); with `q_logits`
the critic's output is the logit of a Q in [0, 1] (QT-Opt's sigmoid
critic): Q is its sigmoid wherever a value is read (the TD target's
delayed critics, CEM's returned Q, the TD errors), and
`td_errors_loss_fn` gets (TD targets, logits), so a cross-entropy is
taken stably from the logit (`common.element_wise_sigmoid_cross_entropy`).
CEM ranks candidates by the logit, which orders them as Q does. The train
step opens the ``agent.loss``, ``agent.grad`` and ``agent.apply`` spans
and counts ``agent.train_steps`` (`utils/profiling.py`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from agents_tpu_torch.agents.agent import (APPLY_SPAN, GRAD_SPAN, LOSS_SPAN,
                                           Agent, apply_gradients,
                                           check_network_devices)
from agents_tpu_torch.policies.cem_policy import CEMPolicy
from agents_tpu_torch.policies.wrappers import (EpsilonGreedyPolicy,
                                                GaussianPolicy)
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, nest_utils, profiling
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device
from agents_tpu_torch.utils.draws import Draws

TRAIN_DRAWS_SEED = 53


@dataclasses.dataclass(frozen=True)
class QtOptAgentState:
  q_network: nn.Module
  target_q_network: nn.Module
  optimizer: torch.optim.Optimizer
  train_step: int
  draws: Any
  # The delayed targets (None when enable_td3 is off).
  target_q_network_delayed: Optional[nn.Module] = None
  target_q_network_delayed_2: Optional[nn.Module] = None


@dataclasses.dataclass(frozen=True)
class QtOptLossExtra:
  td_loss: torch.Tensor
  td_error: torch.Tensor


class QtOptAgent(Agent):
  """QtOpt over a critic of ``((observation, action), step_type, state)``.

  Args:
    q_network: the critic (an nn.Module on `device`), trained in place;
      `init` copies it for the target and the delayed targets.
    optimizer_fn: builds the optimizer from the critic's parameters, e.g.
      ``lambda p: torch.optim.Adam(p, lr=3e-4)``.
    cem_sampler: CEM's actions sampler (`policies/cem_samplers.py`);
      `GaussianContinuousSampler` over the action spec by default.
    q_logits: the critic outputs the logit of Q (see the module
      docstring).
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, q_network: nn.Module,
               optimizer_fn: Callable, epsilon_greedy: float = 0.1,
               n_step_update: int = 1, in_graph_bellman_update: bool = True,
               exploration_noise_std: Optional[float] = None,
               cem_num_samples: int = 32, cem_num_elites: int = 4,
               cem_num_iterations: int = 3, enable_td3: bool = True,
               delayed_target_update_period: int = 5,
               td_errors_loss_fn: Callable = common.element_wise_huber_loss,
               gamma: float = 1.0, reward_scale_factor: float = 1.0,
               target_update_tau: float = 1.0,
               target_update_period: int = 1,
               gradient_clipping: Optional[float] = None,
               cem_sampler=None, q_logits: bool = False, device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, q_network=q_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.q_network = q_network
    self.optimizer_fn = optimizer_fn
    self.n_step_update = n_step_update
    self.in_graph_bellman_update = in_graph_bellman_update
    self.enable_td3 = enable_td3
    self.delayed_target_update_period = delayed_target_update_period
    self.td_errors_loss_fn = td_errors_loss_fn
    self.gamma = gamma
    self.reward_scale_factor = reward_scale_factor
    self.target_update_tau = target_update_tau
    self.target_update_period = target_update_period
    self.gradient_clipping = gradient_clipping
    self.q_logits = q_logits
    self.train_sequence_length = n_step_update + 1
    self.policy = CEMPolicy(time_step_spec, action_spec, q_network,
                            num_samples=cem_num_samples,
                            num_elites=cem_num_elites,
                            num_iterations=cem_num_iterations,
                            sampler=cem_sampler)
    if exploration_noise_std is not None:
      self.collect_policy = GaussianPolicy(self.policy,
                                           scale=exploration_noise_std)
    else:
      self.collect_policy = EpsilonGreedyPolicy(self.policy,
                                                epsilon=epsilon_greedy)

  def init(self, draws=None) -> QtOptAgentState:
    """The state over the agent's critic (trained in place), fresh copies
    for the targets and a new optimizer; the train step's CEM draws come
    from `draws`, or from ``Draws(53, device)``."""
    q = self.q_network
    target = lambda: copy.deepcopy(q).requires_grad_(False)  # noqa: E731
    return QtOptAgentState(
        q_network=q, target_q_network=target(),
        optimizer=self.optimizer_fn(list(q.parameters())), train_step=0,
        draws=draws if draws is not None else Draws(TRAIN_DRAWS_SEED,
                                                    self.device),
        target_q_network_delayed=target() if self.enable_td3 else None,
        target_q_network_delayed_2=target() if self.enable_td3 else None)

  def policy_params(self, agent_state: QtOptAgentState):
    return agent_state.target_q_network

  def _q(self, critic, time_steps, actions):
    q, _ = critic((time_steps.observation, actions), time_steps.step_type, ())
    return q

  def _value(self, output):
    """Q from the critic's output (its sigmoid under `q_logits`)."""
    return torch.sigmoid(output) if self.q_logits else output

  @torch.no_grad()
  def compute_next_q_values(self, agent_state: QtOptAgentState,
                            next_time_steps, policy_info):
    """The next state's value of the TD target (:125-141)."""
    if not self.in_graph_bellman_update:
      if isinstance(policy_info, dict):
        return policy_info["target_q"]
      return policy_info.target_q
    s = agent_state
    next_action, next_q = self.policy.optimize(s.target_q_network,
                                               next_time_steps, s.draws)
    if self.enable_td3:
      return self._value(torch.minimum(
          self._q(s.target_q_network_delayed, next_time_steps, next_action),
          self._q(s.target_q_network_delayed_2, next_time_steps,
                  next_action)))
    return self._value(next_q)

  def _loss(self, q_network, agent_state, experience, weights=None):
    """experience: Trajectory [B, T=n_step+1]."""
    transition = tj.to_n_step_transition(experience, gamma=self.gamma)
    time_steps = transition.time_step
    next_time_steps = transition.next_time_step
    next_q = self.compute_next_q_values(agent_state, next_time_steps,
                                        transition.action_step.info)
    td_targets = (self.reward_scale_factor * next_time_steps.reward
                  + self.gamma * next_time_steps.discount * next_q)
    output = self._q(q_network, time_steps, transition.action_step.action)
    q = self._value(output)
    valid_mask = (~time_steps.is_last()).to(torch.float32)
    td_loss = self.td_errors_loss_fn(td_targets, output) * valid_mask
    loss = common.aggregate_losses(per_example_loss=td_loss,
                                   sample_weight=weights)
    return loss, QtOptLossExtra(td_loss=td_loss,
                                td_error=(td_targets - q) * valid_mask)

  def train(self, agent_state: QtOptAgentState, experience,
            weights=None) -> Tuple[QtOptAgentState, LossInfo]:
    s = agent_state
    with LOSS_SPAN:
      loss, extra = self._loss(s.q_network, s, experience, weights)
    params = list(s.q_network.parameters())
    with GRAD_SPAN:
      grads = torch.autograd.grad(loss, params, allow_unused=True)
    train_step = s.train_step + 1
    with APPLY_SPAN:
      apply_gradients([(grads, params, s.optimizer)],
                      self.gradient_clipping, self.mesh)
      # delayed_2 takes the old delayed, delayed the old target, and only
      # then the target follows the stepped critic.
      if self.enable_td3:
        for source, target in (
            (s.target_q_network_delayed, s.target_q_network_delayed_2),
            (s.target_q_network, s.target_q_network_delayed)):
          common.periodic_soft_update(
              train_step, self.delayed_target_update_period,
              source.parameters(), target.parameters(), 1.0)
      common.periodic_soft_update(
          train_step, self.target_update_period, s.q_network.parameters(),
          s.target_q_network.parameters(), self.target_update_tau)
    profiling.count("agent.train_steps")
    extra = nest_utils.tree_map(torch.Tensor.detach, extra)
    return (dataclasses.replace(s, train_step=train_step),
            LossInfo(loss=loss.detach(), extra=extra))
