"""Greedy, epsilon-greedy, Boltzmann, Gaussian and Ornstein-Uhlenbeck
policy wrappers.

Port of ``agents_tpu/policies/wrappers.py``: `GreedyPolicy` with
`emit_log_probability` (:22-57); `EpsilonGreedyPolicy` (:60-132) with all
its branches: over a wrapped distribution's mode, over a wrapped policy
that acts by optimization (no distribution, as `CEMPolicy`: its `_action`
is the greedy arm), and with exploration kept inside a
`MaskedCategorical`'s mask or a `ShiftedCategorical`'s valid range (a
uniform choice among the valid actions, drawn at "masked_random_action");
`BoltzmannPolicy` (:135-166); and `GaussianPolicy` and `OUNoisePolicy`
(:169-236). The two noise wrappers
draw one normal ``[B, *leaf shape]`` per action leaf, at the sites
"exploration_noise" and "ou_noise", and clip the noisy action into the
spec. `OUNoisePolicy`'s state is ``(wrapped state, tuple of [B, *leaf]
float32 OU states)``; `Policy.action` zeroes its rows at FIRST steps, so
each episode starts its noise process afresh.
"""
from __future__ import annotations

import numpy as np
import torch

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.policies.cem_samplers import is_one_hot
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils


MASKED_RANDOM_ACTION_SITE = "masked_random_action"
RANDOM_ACTION_SITE = "random_action"


def _random_leaf(spec, draws, outer_dims):
  """A uniform random value of one leaf: a uniform one-hot vector for a
  one-hot leaf, else `array_spec.sample_spec`'s."""
  if is_one_hot(spec):
    depth = spec.shape[0]
    index = draws.randint(RANDOM_ACTION_SITE, tuple(outer_dims), 0, depth)
    return torch.nn.functional.one_hot(index.long(), depth).to(
        array_spec.torch_dtype(spec.dtype))
  return array_spec.sample_spec(spec, draws, outer_dims,
                                site=RANDOM_ACTION_SITE)


def _is_dist(d) -> bool:
  return hasattr(d, "mode")


def _mode(dist_nest):
  return nest_utils.tree_map(lambda d: d.mode(), dist_nest, is_leaf=_is_dist)


class GreedyPolicy(Policy):
  """Mode of the wrapped policy's distribution; with the wrapped policy's
  `emit_log_probability`, the info's log-probability is 0."""

  def __init__(self, wrapped: Policy):
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=wrapped.state_spec,
                     emit_log_probability=wrapped.emit_log_probability,
                     clip=wrapped.clip)
    self.wrapped = wrapped

  def _action(self, params, time_step, state, draws):
    dstep = self.wrapped._distribution(params, time_step, state)
    info = dstep.info
    if self.emit_log_probability:
      info = ps.set_log_probability(info, torch.zeros(
          time_step.step_type.shape, dtype=torch.float32,
          device=time_step.step_type.device))
    return ps.PolicyStep(action=_mode(dstep.action), state=dstep.state,
                         info=info)

  def _distribution(self, params, time_step, state):
    """A `Deterministic` at each wrapped distribution's mode, keeping its
    event dims so `log_prob` stays ``[B]`` (wrappers.py:46-57)."""
    dstep = self.wrapped._distribution(params, time_step, state)
    action = nest_utils.tree_map(
        lambda d: dist_lib.Deterministic(
            d.mode(), event_ndims=getattr(
                d, "event_ndims",
                getattr(d, "reinterpreted_batch_ndims", 0))),
        dstep.action, is_leaf=lambda d: hasattr(d, "mode"))
    return ps.PolicyStep(action=action, state=dstep.state, info=dstep.info)


class EpsilonGreedyPolicy(Policy):
  """With probability epsilon act uniformly at random, else greedily.

  `epsilon` is a float or a callable of the policy params (the DQN collect
  policy reads the train step from them). The random action and the coin
  are drawn for every row ("random_action", "explore") and then selected
  with `where`, as in the JAX package. The random action is uniform over
  the spec (`array_spec.sample_spec`), except that a one-hot leaf
  (`cem_samplers.is_one_hot`) is a uniform one-hot vector, one category
  drawn per row at "random_action". A wrapped policy that acts through a
  CEM sampler explores over the sampler's own nest, its draw packed into
  an action as the sampler packs its samples (`ConcatenatedSampler`).
  """

  def __init__(self, wrapped: Policy, epsilon=0.1):
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=wrapped.state_spec, clip=wrapped.clip)
    self.wrapped = wrapped
    self.epsilon = epsilon

  def _epsilon(self, params):
    if callable(self.epsilon):
      return self.epsilon(params)
    return self.epsilon

  def _action(self, params, time_step, state, draws):
    try:
      dstep = self.wrapped._distribution(params, time_step, state)
    except NotImplementedError:
      # A policy that acts by optimization (CEMPolicy) has no distribution:
      # its own action is the greedy arm.
      dstep = None
      greedy = self.wrapped._action(params, time_step, state, draws)
    else:
      greedy = ps.PolicyStep(action=_mode(dstep.action), state=dstep.state,
                             info=dstep.info)
    batch_shape = tuple(time_step.step_type.shape)
    random_action = self._valid_random_action(dstep, draws)
    if random_action is None:
      random_action = self._random_action(draws, batch_shape)
    explore = draws.uniform("explore", batch_shape) < self._epsilon(params)
    return greedy.replace(
        action=nest_utils.where(explore, random_action, greedy.action))

  def _random_action(self, draws, batch_shape):
    sampler = getattr(self.wrapped, "sampler", None)
    spec = self.action_spec if sampler is None else sampler.action_spec
    action = array_spec.map_spec_nest(
        lambda s: _random_leaf(s, draws, batch_shape), spec)
    if sampler is None:
      return action
    return sampler.unflatten(nest_utils.flatten_sorted(action))

  @staticmethod
  def _valid_random_action(dstep, draws):
    """A uniform action among the valid ones of a lone masked or shifted
    Categorical (a nest like the distribution's), else None."""
    leaves = [] if dstep is None else nest_utils.flatten(dstep.action,
                                                         is_leaf=_is_dist)
    if len(leaves) != 1:
      return None
    d = leaves[0]
    if isinstance(d, dist_lib.MaskedCategorical):
      uniform = dist_lib.MaskedCategorical(
          logits=torch.zeros_like(d.logits), mask=d.mask, dtype=d.dtype)
    elif isinstance(d, dist_lib.ShiftedCategorical):
      valid = d.logits > dist_lib.NEG_INF / 2
      uniform = dist_lib.ShiftedCategorical(
          logits=torch.where(valid, 0.0, dist_lib.NEG_INF), shift=d.shift,
          dtype=d.dtype)
    else:
      return None
    sample = uniform.sample(draws, site=MASKED_RANDOM_ACTION_SITE)
    return nest_utils.tree_map(lambda _: sample, dstep.action,
                               is_leaf=_is_dist)

  def _distribution(self, params, time_step, state):
    raise NotImplementedError(
        "EpsilonGreedyPolicy does not expose a distribution")


class BoltzmannPolicy(Policy):
  """Samples the wrapped categorical policy at ``logits / temperature``
  (masked and shifted Categoricals keep their mask and shift); the sample
  is the default `Policy._action`'s, at the site "categorical"."""

  def __init__(self, wrapped: Policy, temperature=1.0):
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=wrapped.state_spec, clip=wrapped.clip)
    self.wrapped = wrapped
    self.temperature = temperature

  def _distribution(self, params, time_step, state):
    dstep = self.wrapped._distribution(params, time_step, state)

    def cool(d):
      if isinstance(d, dist_lib.MaskedCategorical):
        return dist_lib.MaskedCategorical(
            logits=d.logits / self.temperature, mask=d.mask, dtype=d.dtype)
      if isinstance(d, dist_lib.ShiftedCategorical):
        return dist_lib.ShiftedCategorical(
            logits=d.logits / self.temperature, shift=d.shift, dtype=d.dtype)
      if isinstance(d, dist_lib.Categorical):
        return dist_lib.Categorical(logits=d.logits / self.temperature,
                                    dtype=d.dtype)
      raise ValueError("BoltzmannPolicy requires a categorical policy")

    return dstep.replace(action=nest_utils.tree_map(cool, dstep.action,
                                                    is_leaf=_is_dist))


EXPLORATION_NOISE_SITE = "exploration_noise"
OU_NOISE_SITE = "ou_noise"


def _action_leaves(action):
  """The action nest's leaves and a function that rebuilds the nest."""
  leaves = nest_utils.flatten(action)

  def rebuild(new_leaves):
    it = iter(new_leaves)
    return nest_utils.tree_map(lambda _: next(it), action)

  return leaves, rebuild


class GaussianPolicy(Policy):
  """Adds N(0, scale) exploration noise to the wrapped policy's action,
  then clips to the spec."""

  def __init__(self, wrapped: Policy, scale: float = 1.0):
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=wrapped.state_spec, clip=True)
    self.wrapped = wrapped
    self.scale = scale

  def _action(self, params, time_step, state, draws):
    step = self.wrapped._action(params, time_step, state, draws)
    leaves, rebuild = _action_leaves(step.action)
    noisy = [a + self.scale * draws.normal(EXPLORATION_NOISE_SITE, a.shape,
                                           dtype=a.dtype) for a in leaves]
    return step.replace(action=rebuild(noisy))

  def _distribution(self, params, time_step, state):
    raise NotImplementedError("GaussianPolicy acts by adding noise")


class OUNoisePolicy(Policy):
  """Ornstein-Uhlenbeck additive noise: per action leaf the state moves as
  ``s <- (1 - ou_damping) * s + ou_stddev * N(0, 1)`` and the action is
  ``a + s``. The OU states ride in the policy state beside the wrapped
  policy's."""

  def __init__(self, wrapped: Policy, ou_stddev: float = 1.0,
               ou_damping: float = 1.0):
    action_leaves = nest_utils.flatten(wrapped.action_spec,
                                       is_leaf=array_spec._is_spec)
    ou_specs = tuple(array_spec.ArraySpec(s.shape, np.float32, "ou")
                     for s in action_leaves)
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=(wrapped.state_spec, ou_specs), clip=True)
    self.wrapped = wrapped
    self.ou_stddev = ou_stddev
    self.ou_damping = ou_damping

  def init_state(self, batch_size=None, device=None):
    outer = () if batch_size is None else (batch_size,)
    return (self.wrapped.init_state(batch_size, device=device),
            array_spec.zero_spec_nest(self.state_spec[1], outer_dims=outer,
                                      device=device))

  def _action(self, params, time_step, state, draws):
    wrapped_state, ou_state = state
    step = self.wrapped._action(params, time_step, wrapped_state, draws)
    leaves, rebuild = _action_leaves(step.action)
    new_ou, noisy = [], []
    for a, s in zip(leaves, ou_state, strict=True):
      noise = draws.normal(OU_NOISE_SITE, s.shape, dtype=torch.float32)
      s_new = (1.0 - self.ou_damping) * s + noise * self.ou_stddev
      new_ou.append(s_new)
      noisy.append(a + s_new.to(a.dtype))
    return ps.PolicyStep(action=rebuild(noisy),
                         state=(step.state, tuple(new_ou)), info=step.info)

  def _distribution(self, params, time_step, state):
    raise NotImplementedError("OUNoisePolicy acts by adding noise")
