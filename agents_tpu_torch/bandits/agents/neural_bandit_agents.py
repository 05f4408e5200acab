"""Neural bandit agents.

Port of ``agents_tpu/bandits/agents/neural_bandit_agents.py``:
`GreedyRewardPredictionAgent` (with and without constraints),
`NeuralEpsilonGreedyAgent`, `NeuralBoltzmannAgent`, `NeuralFalconAgent`,
`BernoulliThompsonSamplingAgent`, `Exp3Agent` and `NeuralLinUcbAgent`.
The reward network is any Q-style network (an `nn.Module` called as
``net(observation, step_type, state) -> ([B, K], state)``); its
parameters and the optimizer's moments are updated in place, and every
train step is a host int, so Falcon's gamma and NeuralLinUCB's phase are
Python branches with no host read. Over a data-parallel mesh the reward
networks average their gradients (`agents.agent.apply_gradients`) and the
count-based agents sum their statistics over the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.agents.agent import (Agent, apply_gradients,
                                           check_network_devices)
from agents_tpu_torch.bandits.agents.linear_bandit_agent import (
    squeeze_bandit_batch, sufficient_statistics, sum_over_mesh)
from agents_tpu_torch.bandits.networks.global_and_arm_feature_network import \
    dense
from agents_tpu_torch.bandits.policies import constraints as constraints_lib
from agents_tpu_torch.bandits.policies import linalg
from agents_tpu_torch.bandits.policies.linear_bandit_policy import ucb_scores
from agents_tpu_torch.bandits.specs import bandit_spec_utils as bsu
from agents_tpu_torch.networks.network import seeded_generator
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.policies.q_policy import QPolicy
from agents_tpu_torch.policies.wrappers import (BoltzmannPolicy,
                                                EpsilonGreedyPolicy,
                                                GreedyPolicy)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import common
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


def module_parameters(params):
  """The trainable tensors of a module, or of a {"reward", "constraints"}
  dict of them, in order."""
  if isinstance(params, nn.Module):
    return list(params.parameters())
  out = list(params["reward"].parameters())
  for p in params["constraints"]:
    if isinstance(p, nn.Module):
      out.extend(p.parameters())
  return out


def action_dtype(action_spec):
  """The torch dtype of a policy's actions."""
  return array_spec.torch_dtype(action_spec.dtype)


@dataclasses.dataclass(frozen=True)
class RewardNetAgentState:
  params: Any  # the reward network, or {"reward": ..., "constraints": ...}
  optimizer: torch.optim.Optimizer
  train_step: int


class _ConstrainedGreedyPolicy(Policy):
  """Greedy over predicted rewards masked by constraint feasibility.
  Feasibility is Bernoulli-sampled when draws are given (collection),
  thresholded at 0.5 when not (the distribution)."""

  def __init__(self, time_step_spec, action_spec, reward_network,
               constraints, splitter, epsilon: float = 0.0):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.reward_network = reward_network
    self.constraints = tuple(constraints)
    self.splitter = splitter
    self.epsilon = epsilon
    self.num_actions = action_spec.num_values
    self._dtype = action_dtype(action_spec)

  def _masked_preds(self, params, time_step, state, draws):
    obs = time_step.observation
    if draws is not None:
      obs, mask = constraints_lib.construct_mask_from_multiple_sources(
          draws, obs, self.splitter, self.constraints, params["constraints"],
          self.num_actions)
    else:
      if self.splitter is not None:
        obs, mask = self.splitter(obs)
      else:
        mask = None
      prob = constraints_lib.compute_feasibility_probability(
          obs, self.constraints, params["constraints"], self.num_actions,
          mask)
      mask = (prob >= 0.5).to(torch.int32)
    preds, new_state = params["reward"](obs, time_step.step_type, state)
    if mask is not None:
      masked = torch.where(mask > 0, preds, -1e9)
      any_valid = torch.any(mask > 0, dim=-1, keepdim=True)
      preds = torch.where(any_valid, masked, preds)
    return preds, new_state

  def _action(self, params, time_step, state, draws):
    preds, new_state = self._masked_preds(params, time_step, state, draws)
    action = torch.argmax(preds, dim=-1)
    if self.epsilon and draws is not None:
      batch = tuple(time_step.step_type.shape)
      rand = draws.randint("random_action", batch, 0, self.num_actions)
      explore = draws.uniform("explore", batch) < self.epsilon
      action = torch.where(explore, rand, action)
    return ps.PolicyStep(action=action.to(self._dtype), state=new_state,
                         info=())

  def _distribution(self, params, time_step, state):
    preds, new_state = self._masked_preds(params, time_step, state, None)
    best = torch.max(preds, dim=-1, keepdim=True).values
    return ps.PolicyStep(
        action=dist_lib.Categorical(torch.where(preds >= best, 0.0, -1e9),
                                    dtype=self._dtype),
        state=new_state, info=())


class GreedyRewardPredictionAgent(Agent):
  """Supervised reward net + greedy arm choice. With `constraints`, the
  reward is a dict {REWARD_SPEC_KEY, CONSTRAINTS_SPEC_KEY: [B, n_c]} and
  each constraint's network trains jointly; the policies mask infeasible
  arms.

  Args:
    reward_network: the reward network (an nn.Module on `device`).
    optimizer_fn: builds the optimizer from the parameters, e.g.
      ``lambda p: torch.optim.Adam(p, lr=1e-2)`` for ``optax.adam(1e-2)``;
      one optimizer covers the reward network's and then each
      constraint network's parameters.
    device: "cuda" unless the caller asks for "cpu".
  """

  def __init__(self, time_step_spec, action_spec, reward_network,
               optimizer_fn: Callable,
               error_loss_fn: Callable = common.element_wise_squared_loss,
               gradient_clipping: Optional[float] = None,
               constraints=(),
               observation_and_action_constraint_splitter=None,
               device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, reward_network=reward_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.reward_network = reward_network
    self.optimizer_fn = optimizer_fn
    self.error_loss_fn = error_loss_fn
    self.gradient_clipping = gradient_clipping
    self.num_actions = action_spec.num_values
    self.train_sequence_length = None
    self.constraints = tuple(constraints)
    self.splitter = observation_and_action_constraint_splitter

    if self.constraints:
      self.policy = _ConstrainedGreedyPolicy(
          time_step_spec, action_spec, reward_network, self.constraints,
          self.splitter)
      self.collect_policy = self._make_constrained_collect_policy()
      self._q_policy = None
    else:
      q_policy = QPolicy(time_step_spec, action_spec, reward_network,
                         self.splitter)
      self.policy = GreedyPolicy(q_policy)
      self.collect_policy = self._make_collect_policy(q_policy)
      self._q_policy = q_policy

  def _make_collect_policy(self, q_policy):
    return GreedyPolicy(q_policy)

  def _make_constrained_collect_policy(self):
    return self.policy

  def init(self) -> RewardNetAgentState:
    if self.constraints:
      params = {"reward": self.reward_network,
                "constraints": tuple(c.init_params()
                                     for c in self.constraints)}
    else:
      params = self.reward_network
    return RewardNetAgentState(
        params=params, optimizer=self.optimizer_fn(module_parameters(params)),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state.params

  def _loss(self, params, experience, weights=None):
    exp = squeeze_bandit_batch(experience)
    obs = exp.observation
    if self.splitter is not None:
      # Train on the split observation the policy acts on.
      obs, _ = self.splitter(obs)
    if not self.constraints:
      preds, _ = params(obs, exp.step_type, ())
      chosen = common.index_with_actions(preds, exp.action)
      per_example = self.error_loss_fn(exp.reward, chosen)
      return common.aggregate_losses(per_example_loss=per_example,
                                     sample_weight=weights)
    rewards = exp.reward[bsu.REWARD_SPEC_KEY]
    preds, _ = params["reward"](obs, exp.step_type, ())
    chosen = common.index_with_actions(preds, exp.action)
    per_example = self.error_loss_fn(rewards, chosen)
    loss = common.aggregate_losses(per_example_loss=per_example,
                                   sample_weight=weights)
    targets = exp.reward[bsu.CONSTRAINTS_SPEC_KEY]
    for i, c in enumerate(self.constraints):
      loss = loss + c.compute_loss(params["constraints"][i], obs,
                                   exp.action, targets[:, i], weights)
    return loss

  def train(self, agent_state, experience,
            weights=None) -> Tuple[RewardNetAgentState, LossInfo]:
    loss = self._loss(agent_state.params, experience, weights)
    params = module_parameters(agent_state.params)
    apply_gradients([(torch.autograd.grad(loss, params, allow_unused=True),
                      params, agent_state.optimizer)],
                    self.gradient_clipping, self.mesh)
    return (dataclasses.replace(agent_state,
                                train_step=agent_state.train_step + 1),
            LossInfo(loss.detach(), ()))


class NeuralEpsilonGreedyAgent(GreedyRewardPredictionAgent):
  """Epsilon-greedy collection over the reward network."""

  def __init__(self, *args, epsilon: float = 0.1, **kwargs):
    self._epsilon = epsilon
    super().__init__(*args, **kwargs)

  def _make_collect_policy(self, q_policy):
    return EpsilonGreedyPolicy(q_policy, self._epsilon)

  def _make_constrained_collect_policy(self):
    return _ConstrainedGreedyPolicy(
        self.time_step_spec, self.action_spec, self.reward_network,
        self.constraints, self.splitter, epsilon=self._epsilon)


class NeuralBoltzmannAgent(GreedyRewardPredictionAgent):
  """Boltzmann collection at `temperature` over the reward network."""

  def __init__(self, *args, temperature: float = 1.0, **kwargs):
    self._temperature = temperature
    super().__init__(*args, **kwargs)

  def _make_collect_policy(self, q_policy):
    return BoltzmannPolicy(q_policy, self._temperature)


class _FalconPolicy(Policy):
  """FALCON inverse-gap weighting: p(a) proportional to
  1 / (K + gamma * (r_best - r_a)); the best arms share the remainder.
  Its params are {"net": the reward network, "train_step": int}."""

  def __init__(self, time_step_spec, action_spec, reward_network,
               exploitation_coefficient_fn):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.reward_network = reward_network
    self.gamma_fn = exploitation_coefficient_fn
    self.num_actions = action_spec.num_values
    self._dtype = action_dtype(action_spec)

  def _distribution(self, params, time_step, state):
    preds, _ = params["net"](time_step.observation, time_step.step_type, ())
    gamma = self.gamma_fn(params["train_step"])
    best = torch.max(preds, dim=-1, keepdim=True).values
    probs = 1.0 / (self.num_actions + gamma * (best - preds))
    is_best = (preds == best).to(probs.dtype)
    # All best-arm mass = 1 - the sum of the non-best probabilities.
    non_best = torch.sum(probs * (1 - is_best), dim=-1, keepdim=True)
    n_best = torch.clamp(torch.sum(is_best, dim=-1, keepdim=True), min=1.0)
    probs = probs * (1 - is_best) + is_best * (1 - non_best) / n_best
    logits = torch.log(torch.clamp(probs, min=1e-12))
    return ps.PolicyStep(
        action=dist_lib.Categorical(logits, dtype=self._dtype),
        state=state, info=())


class NeuralFalconAgent(GreedyRewardPredictionAgent):
  """Falcon collection; gamma grows with the square root of the train
  steps (a host float, the train step being a host int)."""

  def __init__(self, *args, exploitation_coefficient: float = 1.0,
               **kwargs):
    self._coef = exploitation_coefficient
    super().__init__(*args, **kwargs)
    self.collect_policy = _FalconPolicy(
        self.time_step_spec, self.action_spec, self.reward_network,
        lambda step: self._coef * math.sqrt(float(step) + 1.0))

  def collect_policy_params(self, agent_state):
    return {"net": agent_state.params, "train_step": agent_state.train_step}


@dataclasses.dataclass(frozen=True)
class BernoulliTSState:
  alpha: torch.Tensor  # [K] successes + 1
  beta: torch.Tensor   # [K] failures + 1
  train_step: int


class _BernoulliTSPolicy(Policy):
  """argmax of one Beta(alpha, beta) draw per row and arm, at the site
  "bernoulli_ts_theta"."""

  def __init__(self, time_step_spec, action_spec):
    super().__init__(time_step_spec, action_spec, clip=False)
    self._dtype = action_dtype(action_spec)

  def _action(self, params, time_step, state, draws):
    shape = tuple(time_step.step_type.shape) + tuple(params.alpha.shape)
    theta = draws.beta("bernoulli_ts_theta", params.alpha.expand(shape),
                       params.beta.expand(shape))
    action = torch.argmax(theta, dim=-1).to(self._dtype)
    return ps.PolicyStep(action=action, state=state, info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError


class BernoulliThompsonSamplingAgent(Agent):
  """Beta-Bernoulli posterior per arm."""

  def __init__(self, time_step_spec, action_spec, batch_size: int = 1,
               device="cuda"):
    self.device = resolve_device(device)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.num_actions = action_spec.num_values
    self.train_sequence_length = None
    self.policy = _BernoulliTSPolicy(time_step_spec, action_spec)
    self.collect_policy = self.policy

  def init(self) -> BernoulliTSState:
    ones = torch.ones((self.num_actions,), device=self.device)
    return BernoulliTSState(alpha=ones, beta=ones.clone(), train_step=0)

  def policy_params(self, agent_state):
    return agent_state

  def train(self, agent_state, experience, weights=None):
    exp = squeeze_bandit_batch(experience)
    onehot = torch.nn.functional.one_hot(
        exp.action.long(), self.num_actions).to(torch.float32)
    success, failure = sum_over_mesh(
        self.mesh, torch.sum(onehot * exp.reward[:, None], dim=0),
        torch.sum(onehot * (1.0 - exp.reward)[:, None], dim=0))
    new_state = BernoulliTSState(
        alpha=agent_state.alpha + success, beta=agent_state.beta + failure,
        train_step=agent_state.train_step + 1)
    return new_state, LossInfo(-torch.mean(exp.reward), ())


@dataclasses.dataclass(frozen=True)
class Exp3State:
  log_weights: torch.Tensor  # [K]
  train_step: int


class _Exp3Policy(Policy):

  def __init__(self, time_step_spec, action_spec, learning_rate):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.learning_rate = learning_rate
    self._dtype = action_dtype(action_spec)

  def _distribution(self, params, time_step, state):
    shape = tuple(time_step.step_type.shape) + tuple(
        params.log_weights.shape)
    return ps.PolicyStep(
        action=dist_lib.Categorical(params.log_weights.expand(shape),
                                    dtype=self._dtype),
        state=state, info=())


class Exp3Agent(Agent):
  """Adversarial bandit: exponential weights with importance-weighted
  reward estimates."""

  def __init__(self, time_step_spec, action_spec,
               learning_rate: float = 0.1, device="cuda"):
    self.device = resolve_device(device)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.num_actions = action_spec.num_values
    self.learning_rate = learning_rate
    self.train_sequence_length = None
    self.policy = _Exp3Policy(time_step_spec, action_spec, learning_rate)
    self.collect_policy = self.policy

  def init(self) -> Exp3State:
    return Exp3State(
        log_weights=torch.zeros((self.num_actions,), device=self.device),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state

  def train(self, agent_state, experience, weights=None):
    exp = squeeze_bandit_batch(experience)
    probs = torch.softmax(agent_state.log_weights, dim=-1)
    onehot = torch.nn.functional.one_hot(
        exp.action.long(), self.num_actions).to(torch.float32)
    # Importance-weighted reward estimate per arm.
    (est,) = sum_over_mesh(self.mesh, torch.sum(
        onehot * (exp.reward[:, None] / torch.clamp(probs[None], min=1e-8)),
        dim=0))
    new_state = Exp3State(
        log_weights=agent_state.log_weights + self.learning_rate * est,
        train_step=agent_state.train_step + 1)
    return new_state, LossInfo(-torch.mean(exp.reward), ())


@dataclasses.dataclass(frozen=True)
class NeuralLinUcbState:
  encoder_params: nn.Module  # the encoder with its reward head
  optimizer: torch.optim.Optimizer
  a_mat: torch.Tensor
  b_vec: torch.Tensor
  train_step: int


class EncoderWithRewardHead(nn.Module):
  """The encoder and a Dense reward head over its features, used only to
  train the encoder: ``((features, rewards), state)``. (The JAX package's
  `_WithHead`; its params are {"encoder": ..., "Dense_0": ...}.)"""

  def __init__(self, encoder: nn.Module, encoding_dim: int,
               num_actions: int, device, generator):
    super().__init__()
    self.encoder = encoder
    self.head = dense(encoding_dim, num_actions, device, generator)

  def forward(self, observation, step_type=None, network_state=()):
    feats, network_state = self.encoder(observation, step_type,
                                        network_state)
    return (feats, self.head(feats)), network_state


class _NeuralLinUcbPolicy(Policy):
  """UCB over encoded features; epsilon-greedy while the encoder trains
  (its draws, "random_action" and "explore", are made only then)."""

  def __init__(self, time_step_spec, action_spec, alpha, epsilon_greedy,
               encoding_phase_steps):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.alpha = alpha
    self.epsilon_greedy = epsilon_greedy
    self.encoding_phase_steps = encoding_phase_steps
    self.num_actions = action_spec.num_values
    self._dtype = action_dtype(action_spec)

  def _action(self, params, time_step, state, draws):
    (feats, _), _ = params.encoder_params(time_step.observation,
                                          time_step.step_type, ())
    chol = linalg.cholesky(params.a_mat)
    theta = torch.cholesky_solve(params.b_vec[..., None], chol)[..., 0]
    action = torch.argmax(ucb_scores(chol, theta, feats, self.alpha), dim=-1)
    if params.train_step < self.encoding_phase_steps:
      batch = tuple(time_step.step_type.shape)
      random_action = draws.randint("random_action", batch, 0,
                                    self.num_actions)
      explore = draws.uniform("explore", batch) < self.epsilon_greedy
      action = torch.where(explore, random_action, action)
    return ps.PolicyStep(action=action.to(self._dtype), state=state,
                         info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError


class NeuralLinUcbAgent(Agent):
  """Encoder net + LinUCB head on its features. For the first
  `encoding_phase_steps` train steps the encoder trains through a reward
  head and (A, b) stay frozen; afterwards only (A, b) update.

  Args:
    encoding_network: the encoder (an nn.Module on `device`, e.g.
      `make_encoding_network`), called as ``(obs, step_type, state) ->
      ([B, encoding_dim], state)``.
    optimizer_fn: builds the optimizer over the encoder and head.
    generator: initialises the reward head (seed 0 on the device when
      None).
  """

  def __init__(self, time_step_spec, action_spec, encoding_network,
               encoding_dim: int, optimizer_fn: Callable, alpha: float = 1.0,
               gamma: float = 1.0, epsilon_greedy: float = 0.1,
               encoding_phase_steps: int = 100, device="cuda",
               generator: Optional[torch.Generator] = None):
    self.device = resolve_device(device)
    check_network_devices(self.device, encoding_network=encoding_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.encoder = encoding_network
    self.encoding_dim = encoding_dim
    self.optimizer_fn = optimizer_fn
    self.alpha = alpha
    self.gamma = gamma
    self.num_actions = action_spec.num_values
    self.encoding_phase_steps = encoding_phase_steps
    self.train_sequence_length = None
    self.head_module = EncoderWithRewardHead(
        encoding_network, encoding_dim, self.num_actions, self.device,
        seeded_generator(self.device, generator))
    self.policy = _NeuralLinUcbPolicy(
        time_step_spec, action_spec, alpha, epsilon_greedy,
        encoding_phase_steps)
    self.collect_policy = self.policy

  def init(self) -> NeuralLinUcbState:
    K, d = self.num_actions, self.encoding_dim
    return NeuralLinUcbState(
        encoder_params=self.head_module,
        optimizer=self.optimizer_fn(self.head_module.parameters()),
        a_mat=torch.eye(d, device=self.device).expand(K, d, d).clone(),
        b_vec=torch.zeros((K, d), device=self.device),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state

  def train(self, agent_state, experience, weights=None):
    exp = squeeze_bandit_batch(experience)
    module = agent_state.encoder_params
    in_phase = agent_state.train_step < self.encoding_phase_steps
    with torch.set_grad_enabled(in_phase):
      (feats, preds), _ = module(exp.observation, exp.step_type, ())
      chosen = common.index_with_actions(preds, exp.action)
      loss = torch.mean(torch.square(exp.reward - chosen))
    a_mat, b_vec = agent_state.a_mat, agent_state.b_vec
    if in_phase:
      # Encoding phase: the encoder trains, (A, b) stay frozen (features
      # of a moving encoder would contaminate the UCB statistics).
      params = list(module.parameters())
      apply_gradients([(torch.autograd.grad(loss, params), params,
                        agent_state.optimizer)], None, self.mesh)
    else:
      delta_a, delta_b, _ = sufficient_statistics(
          feats.detach(), exp.reward, exp.action, self.num_actions)
      delta_a, delta_b = sum_over_mesh(self.mesh, delta_a, delta_b)
      # Re-add the decayed identity prior so gamma < 1 forgetting cannot
      # decay A toward singular for rarely pulled arms.
      g = self.gamma
      eye = torch.eye(delta_a.shape[-1], dtype=delta_a.dtype,
                      device=delta_a.device)[None]
      a_mat = g * a_mat + (1 - g) * eye + delta_a
      b_vec = g * b_vec + delta_b
    return dataclasses.replace(
        agent_state, a_mat=a_mat, b_vec=b_vec,
        train_step=agent_state.train_step + 1), LossInfo(loss.detach(), ())
