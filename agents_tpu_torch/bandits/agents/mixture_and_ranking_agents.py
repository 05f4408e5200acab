"""Mixture, dropout-TS, multi-objective and ranking bandit agents.

Port of ``agents_tpu/bandits/agents/mixture_and_ranking_agents.py``:
  - `MixtureAgent` / `StaticMixtureAgent` / `Exp3MixtureAgent`: a
    categorical mixture over sub-agents (the component drawn per row at
    the site "mixture_choice"); each round one sub-agent acts, all train
    on the round;
  - `DropoutThompsonSamplingAgent`: TS through a dropout reward network
    whose forward takes ``dropout_draws=`` at act time (its keep-mask at
    the site "dropout_keep"; see `dropout_keep_mask`);
  - `GreedyMultiObjectiveNeuralAgent`: one reward network per objective,
    scalarized for the arm choice;
  - `RankingAgent`: slates by iterative penalized scoring, trained on
    per-position feedback.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.agents.agent import (Agent, apply_gradients,
                                           check_network_devices)
from agents_tpu_torch.bandits.agents.linear_bandit_agent import (
    squeeze_bandit_batch, sum_over_mesh)
from agents_tpu_torch.bandits.agents.neural_bandit_agents import (
    GreedyRewardPredictionAgent, RewardNetAgentState, action_dtype)
from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
    PER_ARM_FEATURE_KEY)
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import common
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device

MIXTURE_CHOICE_SITE = "mixture_choice"
DROPOUT_KEEP_SITE = "dropout_keep"


# ---------------------------------------------------------------------------
# Mixture agents
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixtureAgentState:
  sub_states: Tuple
  mixture_log_weights: torch.Tensor
  train_step: int


class _MixturePolicy(Policy):
  """The chosen component and its behaviour probability at collection
  time ride in the policy info, so Exp3's credit goes to the sub-agent
  that acted, importance-weighted by the probability it acted with."""

  def __init__(self, time_step_spec, action_spec, sub_policies):
    super().__init__(
        time_step_spec, action_spec, clip=False,
        info_spec={
            "mixture_choice": array_spec.BoundedArraySpec(
                (), np.int32, 0, len(sub_policies) - 1, "mixture_choice"),
            "mixture_prob": array_spec.ArraySpec((), np.float32,
                                                 "mixture_prob"),
        })
    self.sub_policies = tuple(sub_policies)

  def _action(self, params, time_step, state, draws):
    agent_state, sub_params = params
    logw = agent_state.mixture_log_weights
    batch = tuple(time_step.step_type.shape)
    choice = dist_lib.Categorical(logw.expand(batch + tuple(logw.shape)),
                                  dtype=torch.int64).sample(
                                      draws, site=MIXTURE_CHOICE_SITE)
    actions = [pol._action(p, time_step, (), draws).action
               for pol, p in zip(self.sub_policies, sub_params)]
    stacked = torch.stack(actions, dim=0)                      # [N, B]
    action = torch.gather(stacked, 0, choice[None, :])[0]
    probs = torch.softmax(logw, dim=-1)
    return ps.PolicyStep(
        action=action, state=state,
        info={"mixture_choice": choice.to(torch.int32),
              "mixture_prob": probs[choice].to(torch.float32)})

  def _distribution(self, params, time_step, state):
    raise NotImplementedError


class MixtureAgent(Agent):
  """Fixed or learned categorical mixture over sub-agents."""

  def __init__(self, time_step_spec, action_spec, agents: Sequence[Agent],
               mixture_weights: Optional[Sequence[float]] = None,
               learning_rate: float = 0.0, device="cuda"):
    self.device = resolve_device(device)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.agents = tuple(agents)
    self.learning_rate = learning_rate
    self.train_sequence_length = None
    if mixture_weights is None:
      mixture_weights = [1.0] * len(agents)
    w = np.asarray(mixture_weights, np.float32)
    self._init_logw = np.log(w / np.sum(w)).astype(np.float32)
    self.policy = _MixturePolicy(
        time_step_spec, action_spec,
        [a.collect_policy for a in self.agents])
    self.collect_policy = self.policy

  @property
  def mesh(self):
    return self._mesh

  @mesh.setter
  def mesh(self, mesh):
    self._mesh = mesh
    for a in self.agents:
      a.mesh = mesh

  _mesh = None

  def init(self) -> MixtureAgentState:
    return MixtureAgentState(
        sub_states=tuple(a.init() for a in self.agents),
        mixture_log_weights=torch.as_tensor(self._init_logw,
                                            device=self.device),
        train_step=0)

  def policy_params(self, agent_state):
    return (agent_state,
            tuple(a.policy_params(s)
                  for a, s in zip(self.agents, agent_state.sub_states)))

  def train(self, agent_state, experience, weights=None):
    new_subs, losses = [], []
    for a, s in zip(self.agents, agent_state.sub_states):
      ns, li = a.train(s, experience)
      new_subs.append(ns)
      losses.append(li.loss)
    logw = agent_state.mixture_log_weights
    if self.learning_rate > 0:
      exp = squeeze_bandit_batch(experience)
      # Exp3: importance-weighted credit only to the component that
      # produced each action, r / p_c with p_c recorded at collection.
      choice = exp.policy_info["mixture_choice"].long()
      behavior_prob = exp.policy_info["mixture_prob"]           # [B]
      onehot = torch.nn.functional.one_hot(choice, len(self.agents))
      est = onehot * (exp.reward
                      / torch.clamp(behavior_prob, min=1e-8))[:, None]
      total, count = sum_over_mesh(
          self.mesh, torch.sum(est, dim=0),
          torch.full((1,), est.shape[0], dtype=est.dtype, device=est.device))
      logw = logw + self.learning_rate * (total / count)
    new_state = MixtureAgentState(
        sub_states=tuple(new_subs), mixture_log_weights=logw,
        train_step=agent_state.train_step + 1)
    total_loss = losses[0]
    for l in losses[1:]:
      total_loss = total_loss + l
    return new_state, LossInfo(total_loss, ())


class StaticMixtureAgent(MixtureAgent):
  def __init__(self, *args, **kwargs):
    kwargs["learning_rate"] = 0.0
    super().__init__(*args, **kwargs)


class Exp3MixtureAgent(MixtureAgent):
  def __init__(self, *args, learning_rate: float = 0.01, **kwargs):
    kwargs["learning_rate"] = learning_rate
    super().__init__(*args, **kwargs)


# ---------------------------------------------------------------------------
# Dropout Thompson sampling
# ---------------------------------------------------------------------------


def dropout_keep_mask(draws, shape, rate: float) -> torch.Tensor:
  """Dropout's keep-mask for a reward network's act-time forward: a unit
  is kept where its uniform at "dropout_keep" is below 1 - rate (flax's
  ``bernoulli(rng, 1 - rate)``); kept units are scaled by 1 / (1 - rate)
  by the caller."""
  return draws.uniform(DROPOUT_KEEP_SITE, shape) < 1.0 - rate


class _DropoutTSPolicy(Policy):
  """Samples a dropout mask at act time: an approximate posterior
  sample."""

  def __init__(self, time_step_spec, action_spec, network):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.network = network
    self._dtype = action_dtype(action_spec)

  def _action(self, params, time_step, state, draws):
    preds, _ = params(time_step.observation, time_step.step_type, (),
                      dropout_draws=draws)
    action = torch.argmax(preds, dim=-1).to(self._dtype)
    return ps.PolicyStep(action=action, state=state, info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError


class DropoutThompsonSamplingAgent(GreedyRewardPredictionAgent):
  """The reward network must use dropout: its forward takes
  ``dropout_draws`` (a draw source, or None for no dropout) and draws its
  mask with `dropout_keep_mask`; training runs it without dropout."""

  def _make_collect_policy(self, q_policy):
    return _DropoutTSPolicy(self.time_step_spec, self.action_spec,
                            self.reward_network)


# ---------------------------------------------------------------------------
# Multi-objective
# ---------------------------------------------------------------------------


class _ScalarizedGreedyPolicy(Policy):

  def __init__(self, time_step_spec, action_spec, networks_, scalarizer):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.networks_ = tuple(networks_)
    self.scalarizer = scalarizer
    self._dtype = action_dtype(action_spec)

  def _action(self, params, time_step, state, draws):
    preds = [net(time_step.observation, time_step.step_type, ())[0]
             for net in params]                              # [B, K] each
    scores = self.scalarizer(torch.stack(preds, dim=-1))     # [B, K]
    action = torch.argmax(scores, dim=-1).to(self._dtype)
    return ps.PolicyStep(action=action, state=state, info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class MultiObjectiveState:
  params: Tuple
  optimizers: Tuple
  train_step: int


class GreedyMultiObjectiveNeuralAgent(Agent):
  """One reward network per objective; scalarized greedy arm choice.
  Experience reward must be [B, num_objectives]. Each network has its own
  optimizer (`optimizer_fn` of its parameters)."""

  def __init__(self, time_step_spec, action_spec, objective_networks,
               scalarizer, optimizer_fn: Callable, device="cuda"):
    self.device = resolve_device(device)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.networks_ = tuple(objective_networks)
    check_network_devices(self.device, **{
        f"objective_network_{i}": n for i, n in enumerate(self.networks_)})
    self.scalarizer = scalarizer
    self.optimizer_fn = optimizer_fn
    self.train_sequence_length = None
    self.policy = _ScalarizedGreedyPolicy(time_step_spec, action_spec,
                                          self.networks_, scalarizer)
    self.collect_policy = self.policy

  def init(self) -> MultiObjectiveState:
    return MultiObjectiveState(
        params=self.networks_,
        optimizers=tuple(self.optimizer_fn(n.parameters())
                         for n in self.networks_),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state.params

  def train(self, agent_state, experience, weights=None):
    exp = squeeze_bandit_batch(experience)
    groups, total = [], 0.0
    for i, (net, opt) in enumerate(zip(agent_state.params,
                                       agent_state.optimizers)):
      preds, _ = net(exp.observation, exp.step_type, ())
      chosen = common.index_with_actions(preds, exp.action)
      loss = torch.mean(torch.square(exp.reward[..., i] - chosen))
      params = list(net.parameters())
      groups.append((torch.autograd.grad(loss, params), params, opt))
      total = total + loss.detach()
    apply_gradients(groups, None, self.mesh)
    return dataclasses.replace(
        agent_state, train_step=agent_state.train_step + 1), \
        LossInfo(total, ())


# ---------------------------------------------------------------------------
# Ranking
# ---------------------------------------------------------------------------


class _RankingPolicy(Policy):
  """Builds a slate of `slate_size` items by iterative penalized scoring:
  after an item is picked, later picks are penalized by their cosine
  similarity to the picked arms' features."""

  def __init__(self, time_step_spec, action_spec, reward_network,
               slate_size, diversity_penalty=0.0):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.reward_network = reward_network
    self.slate_size = slate_size
    self.diversity_penalty = diversity_penalty
    self._dtype = action_dtype(action_spec)

  def _action(self, params, time_step, state, draws):
    scores, _ = params(time_step.observation, time_step.step_type, ())
    arms = time_step.observation[PER_ARM_FEATURE_KEY]          # [B, K, a]
    unit = arms / (torch.linalg.vector_norm(arms, dim=-1, keepdim=True)
                   + 1e-8)
    chosen = torch.zeros(scores.shape, dtype=torch.bool,
                         device=scores.device)
    penalty = torch.zeros_like(scores)
    slate = []
    for _ in range(self.slate_size):
      eff = scores - self.diversity_penalty * penalty
      eff = torch.where(chosen, -1e9, eff)
      idx = torch.argmax(eff, dim=-1)                            # [B]
      picked = torch.gather(unit, 1, idx[:, None, None].expand(
          -1, 1, unit.shape[-1]))                                # [B, 1, a]
      penalty = penalty + torch.abs(torch.sum(unit * picked, dim=-1))
      chosen = chosen | torch.nn.functional.one_hot(
          idx, scores.shape[-1]).bool()
      slate.append(idx)
    return ps.PolicyStep(action=torch.stack(slate, dim=1).to(self._dtype),
                         state=state, info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError


class RankingAgent(Agent):
  """Slate ranking trained on per-position feedback: each slotted item's
  prediction regresses onto its position's reward."""

  def __init__(self, time_step_spec, action_spec, reward_network,
               optimizer_fn: Callable, slate_size: int,
               diversity_penalty: float = 0.0, device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, reward_network=reward_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.reward_network = reward_network
    self.optimizer_fn = optimizer_fn
    self.slate_size = slate_size
    self.train_sequence_length = None
    self.policy = _RankingPolicy(time_step_spec, action_spec,
                                 reward_network, slate_size,
                                 diversity_penalty)
    self.collect_policy = self.policy

  def init(self) -> RewardNetAgentState:
    return RewardNetAgentState(
        params=self.reward_network,
        optimizer=self.optimizer_fn(self.reward_network.parameters()),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state.params

  def train(self, agent_state, experience, weights=None):
    """experience.action: [B, slate]; experience.reward: [B, slate]
    per-position feedback."""
    exp = squeeze_bandit_batch(experience)
    net = agent_state.params
    preds, _ = net(exp.observation, exp.step_type, ())          # [B, K]
    slate_preds = torch.gather(preds, -1, exp.action.long())   # [B, slate]
    loss = torch.mean(torch.square(exp.reward - slate_preds))
    params = list(net.parameters())
    apply_gradients([(torch.autograd.grad(loss, params), params,
                      agent_state.optimizer)], None, self.mesh)
    return dataclasses.replace(
        agent_state, train_step=agent_state.train_step + 1), \
        LossInfo(loss.detach(), ())
