"""Greedy-over-Q policies: Q values and C51's expectation over atoms.

Port of `QPolicy` and `CategoricalQPolicy` of
``agents_tpu/policies/q_policy.py``, unmasked and unshifted: action specs
start at 0 and no action-constraint splitter is taken yet.
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

  def __init__(self, time_step_spec, action_spec, q_network):
    super().__init__(time_step_spec, action_spec,
                     state_spec=q_network.state_spec, clip=False)
    self.q_network = q_network
    spec = nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec)[0]
    if int(np.min(spec.minimum)) != 0:
      raise NotImplementedError(
          "QPolicy is ported for action specs whose minimum is 0")
    self._action_dtype = array_spec.torch_dtype(spec.dtype)

  def q_values(self, params, time_step, state=()):
    return params(time_step.observation, time_step.step_type, state)

  def _distribution(self, params, time_step, state):
    q, new_state = self.q_values(params, time_step, state)
    dist = dist_lib.Categorical(logits=q, dtype=self._action_dtype)
    return ps.PolicyStep(action=dist, state=new_state, info=())


class CategoricalQPolicy(QPolicy):
  """C51: Q = sum over atoms of softmax(logits) * support, then as QPolicy.

  The support is ``linspace(min_q_value, max_q_value, num_atoms)``.
  """

  def __init__(self, time_step_spec, action_spec, q_network, min_q_value,
               max_q_value):
    super().__init__(time_step_spec, action_spec, q_network)
    self.min_q_value = float(min_q_value)
    self.max_q_value = float(max_q_value)
    self.num_atoms = q_network.num_atoms

  def support(self, device) -> torch.Tensor:
    return torch.linspace(self.min_q_value, self.max_q_value, self.num_atoms,
                          device=device)

  def q_values(self, params, time_step, state=()):
    logits, new_state = params(time_step.observation, time_step.step_type,
                               state)                      # [B, A, atoms]
    probs = torch.softmax(logits, dim=-1)
    return (probs * self.support(logits.device)).sum(-1), new_state
