"""Greedy-over-Q policies: Q values and C51's expectation over atoms.

Port of `QPolicy` and `CategoricalQPolicy` of
``agents_tpu/policies/q_policy.py``, with both of its action-space
variants (:37-62):
  - an `observation_and_action_constraint_splitter` maps the observation to
    ``(network observation, mask)``; the Q values become the logits of a
    `MaskedCategorical` whose invalid actions never win or get sampled;
  - an action spec whose minimum is not 0 gives a `ShiftedCategorical`
    over ``[minimum, minimum + K)``, any mask folded into its logits as
    `NEG_INF`.
"""
from __future__ import annotations

import numpy as np
import torch

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils


class QPolicy(Policy):
  """Q values as the logits of a Categorical whose mode is the argmax.

  `params` at act time is the Q network module to evaluate (the online
  network, or any module of the same architecture).
  """

  def __init__(self, time_step_spec, action_spec, q_network,
               observation_and_action_constraint_splitter=None,
               emit_log_probability: bool = False):
    super().__init__(time_step_spec, action_spec,
                     state_spec=q_network.state_spec,
                     emit_log_probability=emit_log_probability, clip=False)
    self.q_network = q_network
    self.splitter = observation_and_action_constraint_splitter
    spec = nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec)[0]
    self._action_dtype = array_spec.torch_dtype(spec.dtype)
    self._shift = int(np.asarray(getattr(spec, "minimum", 0)))

  def split(self, observation):
    """(network observation, mask or None)."""
    if self.splitter is None:
      return observation, None
    return self.splitter(observation)

  def q_values(self, params, time_step, state=()):
    obs, _ = self.split(time_step.observation)
    return params(obs, time_step.step_type, state)

  def _distribution(self, params, time_step, state):
    q, new_state = self.q_values(params, time_step, state)
    _, mask = self.split(time_step.observation)
    if self._shift != 0:
      if mask is not None:
        q = torch.where(mask, q, dist_lib.NEG_INF)
      dist = dist_lib.ShiftedCategorical(logits=q, shift=self._shift,
                                         dtype=self._action_dtype)
    elif mask is not None:
      dist = dist_lib.MaskedCategorical(logits=q, mask=mask,
                                        dtype=self._action_dtype)
    else:
      dist = dist_lib.Categorical(logits=q, dtype=self._action_dtype)
    return ps.PolicyStep(action=dist, state=new_state, info=())


class CategoricalQPolicy(QPolicy):
  """C51: Q = sum over atoms of softmax(logits) * support, then as QPolicy.

  The support is ``linspace(min_q_value, max_q_value, num_atoms)``.
  """

  def __init__(self, time_step_spec, action_spec, q_network, min_q_value,
               max_q_value, observation_and_action_constraint_splitter=None,
               emit_log_probability: bool = False):
    super().__init__(time_step_spec, action_spec, q_network,
                     observation_and_action_constraint_splitter,
                     emit_log_probability)
    self.min_q_value = float(min_q_value)
    self.max_q_value = float(max_q_value)
    self.num_atoms = q_network.num_atoms

  def support(self, device) -> torch.Tensor:
    return torch.linspace(self.min_q_value, self.max_q_value, self.num_atoms,
                          device=device)

  def q_values(self, params, time_step, state=()):
    obs, _ = self.split(time_step.observation)
    logits, new_state = params(obs, time_step.step_type, state)  # [B, A, N]
    probs = torch.softmax(logits, dim=-1)
    return (probs * self.support(logits.device)).sum(-1), new_state
