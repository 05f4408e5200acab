"""Trainable action-feasibility constraints for bandit policies.

Port of ``agents_tpu/bandits/policies/constraints.py``. Constraints are
stateless objects over explicit params: a `NeuralConstraint`'s params are
its network module, which the owning agent keeps in its state and trains
with the reward network in one backward pass.
`construct_mask_from_multiple_sources` draws its Bernoulli mask at the
site "constraint_mask" (uniform [B, K]).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import torch

from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
    NUM_ACTIONS_FEATURE_KEY)
from agents_tpu_torch.utils import common, nest_utils


def pinball_loss(y_true, y_pred, quantile: float = 0.5):
  """Quantile-regression (pinball) loss, elementwise."""
  err = y_true - y_pred
  return torch.maximum(quantile * err, (quantile - 1.0) * err)


def _batch_size(observation) -> int:
  return nest_utils.flatten(observation)[0].shape[0]


def _device(observation):
  return nest_utils.flatten(observation)[0].device


class BaseConstraint:
  """Feasibility: the probability of each action being feasible."""

  def __init__(self, time_step_spec, action_spec, name: str = "Constraint"):
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.name = name
    self.num_actions = int(action_spec.num_values)

  def init_params(self) -> Any:
    """This constraint's trainable params (a module; () if none)."""
    return ()

  def compute_loss(self, params, observations, actions, rewards,
                   weights=None) -> torch.Tensor:
    """Scalar loss for training the constraint's network (0 if frozen)."""
    del params, actions, rewards, weights
    return torch.zeros((), device=_device(observations))

  def __call__(self, params, observation) -> torch.Tensor:
    """[B, num_actions] probability of each action being feasible."""
    raise NotImplementedError


class NeuralConstraint(BaseConstraint):
  """Trainable constraint backed by a network predicting per-action
  values. The base class regresses observed rewards and declares every
  action feasible; subclasses derive feasibility from the predictions."""

  def __init__(self, time_step_spec, action_spec, constraint_network,
               error_loss_fn: Callable = common.element_wise_squared_loss,
               name: str = "NeuralConstraint"):
    super().__init__(time_step_spec, action_spec, name)
    self.constraint_network = constraint_network
    self.error_loss_fn = error_loss_fn

  def init_params(self):
    return self.constraint_network

  def _predict(self, params, observation):
    values, _ = params(observation, None, ())
    return values  # [B, num_actions]

  def compute_loss(self, params, observations, actions, rewards,
                   weights=None):
    """Regression of the chosen action's prediction onto the observed
    constraint signal."""
    predicted = self._predict(params, observations)
    chosen = common.index_with_actions(predicted, actions)
    per_example = self.error_loss_fn(rewards, chosen)
    if weights is not None:
      per_example = per_example * weights
    return torch.mean(per_example)

  def __call__(self, params, observation):
    return torch.ones((_batch_size(observation), self.num_actions),
                      device=_device(observation))


def _baseline(predicted, observation, baseline_action_fn):
  if baseline_action_fn is not None:
    baseline_action = baseline_action_fn(observation)
  else:
    baseline_action = torch.zeros((predicted.shape[0],), dtype=torch.int64,
                                  device=predicted.device)
  return common.index_with_actions(predicted, baseline_action)


class RelativeConstraint(NeuralConstraint):
  """expected_value(action) >=/<= (1 - margin) * expected_value(baseline)."""

  def __init__(self, time_step_spec, action_spec, constraint_network,
               error_loss_fn: Callable = common.element_wise_squared_loss,
               comparator_fn: Callable = torch.gt, margin: float = 0.0,
               baseline_action_fn: Optional[Callable] = None,
               name: str = "RelativeConstraint"):
    super().__init__(time_step_spec, action_spec, constraint_network,
                     error_loss_fn, name)
    self.comparator_fn = comparator_fn
    self.margin = margin
    self.baseline_action_fn = baseline_action_fn

  def __call__(self, params, observation):
    predicted = self._predict(params, observation)
    baseline = _baseline(predicted, observation, self.baseline_action_fn)
    ok = self.comparator_fn(predicted, (1.0 - self.margin) * baseline[:, None])
    return ok.to(torch.float32)


class AbsoluteConstraint(NeuralConstraint):
  """expected_value(action) >=/<= absolute_value."""

  def __init__(self, time_step_spec, action_spec, constraint_network,
               error_loss_fn: Callable = common.element_wise_squared_loss,
               comparator_fn: Callable = torch.gt,
               absolute_value: float = 0.0, name: str = "AbsoluteConstraint"):
    super().__init__(time_step_spec, action_spec, constraint_network,
                     error_loss_fn, name)
    self.comparator_fn = comparator_fn
    self.absolute_value = absolute_value

  def __call__(self, params, observation):
    predicted = self._predict(params, observation)
    return self.comparator_fn(predicted, self.absolute_value).to(
        torch.float32)


class QuantileConstraint(NeuralConstraint):
  """Q_tau(action) >=/<= quantile_value; the net trains with the pinball
  loss."""

  def __init__(self, time_step_spec, action_spec, constraint_network,
               quantile: float = 0.5, comparator_fn: Callable = torch.gt,
               quantile_value: float = 0.0, name: str = "QuantileConstraint"):
    super().__init__(
        time_step_spec, action_spec, constraint_network,
        error_loss_fn=lambda t, p: pinball_loss(t, p, quantile), name=name)
    self.comparator_fn = comparator_fn
    self.quantile_value = quantile_value

  def __call__(self, params, observation):
    predicted = self._predict(params, observation)
    return self.comparator_fn(predicted, self.quantile_value).to(
        torch.float32)


class RelativeQuantileConstraint(NeuralConstraint):
  """Q_tau(action) >=/<= Q_tau(baseline_action)."""

  def __init__(self, time_step_spec, action_spec, constraint_network,
               quantile: float = 0.5, comparator_fn: Callable = torch.gt,
               baseline_action_fn: Optional[Callable] = None,
               name: str = "RelativeQuantileConstraint"):
    super().__init__(
        time_step_spec, action_spec, constraint_network,
        error_loss_fn=lambda t, p: pinball_loss(t, p, quantile), name=name)
    self.comparator_fn = comparator_fn
    self.baseline_action_fn = baseline_action_fn

  def __call__(self, params, observation):
    predicted = self._predict(params, observation)
    baseline = _baseline(predicted, observation, self.baseline_action_fn)
    return self.comparator_fn(predicted, baseline[:, None]).to(torch.float32)


class InputNetworkConstraint(BaseConstraint):
  """Constraint from an already-trained network: no loss contribution.
  Subclass and implement ``__call__``."""

  def __init__(self, time_step_spec, action_spec, input_network=None,
               name: str = "InputNetworkConstraint"):
    super().__init__(time_step_spec, action_spec, name)
    self.network = input_network


def compute_feasibility_probability(
    observation, constraints: Iterable[BaseConstraint],
    constraint_params: Sequence[Any], num_actions: int,
    action_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
  """[B, num_actions] product of independent constraints' feasibility."""
  if action_mask is not None:
    prob = action_mask.to(torch.float32)
  else:
    prob = torch.ones((_batch_size(observation), num_actions),
                      device=_device(observation))
  for c, p in zip(constraints, constraint_params):
    prob = prob * c(p, observation)
  return prob


def construct_mask_from_multiple_sources(
    draws, observation, observation_and_action_constraint_splitter,
    constraints: Sequence[BaseConstraint], constraint_params: Sequence[Any],
    max_num_actions: int) -> Tuple[Any, Optional[torch.Tensor]]:
  """Combines (1) an action mask embedded in the observation, (2) the
  ``num_actions`` feature limiting per-sample arm counts, and (3) the
  constraints' feasibility, Bernoulli-sampled into a 0/1 mask. Returns
  (network observation, mask or None)."""
  mask = None
  if observation_and_action_constraint_splitter is not None:
    observation, mask = observation_and_action_constraint_splitter(observation)
  # Independent sources combined by AND: arms beyond a sample's
  # num_actions are padding and stay masked.
  if (isinstance(observation, dict)
      and NUM_ACTIONS_FEATURE_KEY in observation):
    num = observation[NUM_ACTIONS_FEATURE_KEY]
    arange = torch.arange(max_num_actions, device=num.device)
    num_mask = (arange[None, :] < num.reshape(-1, 1)).to(torch.int32)
    mask = num_mask if mask is None else mask * num_mask
  if constraints:
    prob = compute_feasibility_probability(
        observation, constraints, constraint_params, max_num_actions, mask)
    u = draws.uniform("constraint_mask", prob.shape)
    mask = (u < prob).to(torch.int32)
  return observation, mask
