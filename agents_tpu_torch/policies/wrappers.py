"""Greedy and epsilon-greedy policy wrappers.

Port of `GreedyPolicy` and `EpsilonGreedyPolicy` of
``agents_tpu/policies/wrappers.py`` (:22-127), unmasked branch.
"""
from __future__ import annotations

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
