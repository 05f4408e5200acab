"""The cross-entropy method's action optimizer over a Q network (QtOpt).

Port of `CEMPolicy` of ``agents_tpu/policies/cem_policy.py`` (:25-81).
`optimize(params, time_step, draws)` starts from the sampler's initial
distribution and, for `num_iterations` (a Python loop), draws N candidate
actions for each of the B rows, scores all N·B of them in one batched
critic call (the observations tiled N times), takes the E best of each
row with `torch.topk` over ``[B, N]`` and refits the distribution to them.
It returns the sampler's mode and the critic's Q there. Nothing in it
reads the card from the host: the shapes depend on N, B and E alone.

`params` is the critic module, called as ``critic((observation, action),
step_type, state)``. The policy acts by optimization, so `_distribution`
raises `NotImplementedError`; `EpsilonGreedyPolicy` then takes its action
as the greedy arm.

A critic whose action enters after an observation-only torso offers
``features(observation)`` and ``head(features, action, observation)``
(QT-Opt's, ``networks/qtopt_networks.py``). `optimize` then runs each
row's observation through the torso once and scores the ``[N, B]``
candidates, and the final mode, with `head` on those features; a critic
without `features` is scored by the tiled path above, unchanged. Both
paths take the same draws and pick the same elites, up to float
rounding.

Each `optimize` is a span, ``cem.optimize`` (`utils/profiling.py`), and
counts the candidate actions it scored, the final mode's included
(``cem.candidates``), and the observations it ran through a critic's
torso (``cem.torso_images``: one a row on the split path, one a
candidate on the tiled path).
"""
from __future__ import annotations

from typing import Optional

import torch

from agents_tpu_torch.policies.cem_samplers import (ActionsSampler,
                                                    GaussianContinuousSampler)
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils, profiling

_OPTIMIZE = profiling.annotate("cem.optimize")


class CEMPolicy(Policy):
  """argmax_a Q(s, a) by CEM; the sampler defines the action space
  (default: a Gaussian over bounded continuous leaves)."""

  def __init__(self, time_step_spec, action_spec, q_network,
               num_samples: int = 32, num_elites: int = 4,
               num_iterations: int = 3, initial_std: float = 0.33,
               sampler: Optional[ActionsSampler] = None):
    super().__init__(time_step_spec, action_spec, clip=True)
    self.q_network = q_network
    self.num_samples = num_samples
    self.num_elites = num_elites
    self.num_iterations = num_iterations
    self.initial_std = initial_std
    self.sampler = sampler or GaussianContinuousSampler(action_spec)

  @staticmethod
  def _features(params, observation):
    """The critic's per-row features, or None where it has no split."""
    features = getattr(params, "features", None)
    return None if features is None else features(observation)

  def _eval_q(self, params, time_step, sample_leaves, features=None):
    """sample_leaves: tuple of [N, B, ...] -> q [N, B]."""
    if features is not None:
      return params.head(features, self.sampler.unflatten(
          list(sample_leaves)), time_step.observation)
    n, b = sample_leaves[0].shape[:2]
    action = self.sampler.unflatten(
        [a.reshape((n * b,) + tuple(a.shape[2:])) for a in sample_leaves])

    def tile(x):
      return x.unsqueeze(0).expand((n,) + tuple(x.shape)).reshape(
          (n * b,) + tuple(x.shape[1:]))

    obs = nest_utils.tree_map(tile, time_step.observation)
    q, _ = params((obs, action), tile(time_step.step_type), ())
    return q.reshape(n, b)

  @_OPTIMIZE
  def optimize(self, params, time_step, draws):
    """Returns (best action nest [B, ...], its Q [B])."""
    batch_size = time_step.step_type.shape[0]
    features = self._features(params, time_step.observation)
    dist_params = self.sampler.init(batch_size, self.initial_std,
                                    device=time_step.step_type.device)
    for _ in range(self.num_iterations):
      samples = self.sampler.sample_batch_and_clip(draws, self.num_samples,
                                                   dist_params)
      q = self._eval_q(params, time_step, samples, features)     # [N, B]
      elite_idx = torch.topk(q.T, self.num_elites, dim=-1).indices  # [B, E]
      dist_params = self.sampler.refit_distribution_to(elite_idx, samples)
    action = self.sampler.unflatten(list(self.sampler.mode(dist_params)))
    if features is None:
      q_final, _ = params((time_step.observation, action),
                          time_step.step_type, ())
    else:
      q_final = params.head(features, action, time_step.observation)
    candidates = (self.num_iterations * self.num_samples + 1) * batch_size
    profiling.count("cem.candidates", candidates)
    profiling.count("cem.torso_images",
                    candidates if features is None else batch_size)
    return action, q_final

  def _action(self, params, time_step, state, draws):
    action, _ = self.optimize(params, time_step, draws)
    return ps.PolicyStep(action=action, state=state, info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError("CEMPolicy acts by optimization")
