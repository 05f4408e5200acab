"""Greedy, epsilon-greedy, Gaussian and Ornstein-Uhlenbeck policy wrappers.

Port of `GreedyPolicy` and `EpsilonGreedyPolicy` of
``agents_tpu/policies/wrappers.py`` (:22-127), unmasked branch, and of
`GaussianPolicy` and `OUNoisePolicy` (:169-236). The two noise wrappers
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
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils


def _mode(dist_nest):
  return nest_utils.tree_map(lambda d: d.mode(), dist_nest,
                             is_leaf=lambda d: hasattr(d, "mode"))


class GreedyPolicy(Policy):
  """Mode of the wrapped policy's distribution."""

  def __init__(self, wrapped: Policy):
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=wrapped.state_spec, clip=wrapped.clip)
    self.wrapped = wrapped

  def _action(self, params, time_step, state, draws):
    dstep = self.wrapped._distribution(params, time_step, state)
    return ps.PolicyStep(action=_mode(dstep.action), state=dstep.state,
                         info=dstep.info)

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
  with `where`, as in the JAX package.
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
    dstep = self.wrapped._distribution(params, time_step, state)
    greedy_action = _mode(dstep.action)
    batch_shape = tuple(time_step.step_type.shape)
    random_action = array_spec.sample_spec_nest(
        self.action_spec, draws, outer_dims=batch_shape, site="random_action")
    explore = draws.uniform("explore", batch_shape) < self._epsilon(params)
    action = nest_utils.where(explore, random_action, greedy_action)
    return ps.PolicyStep(action=action, state=dstep.state, info=dstep.info)

  def _distribution(self, params, time_step, state):
    raise NotImplementedError(
        "EpsilonGreedyPolicy does not expose a distribution")


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
