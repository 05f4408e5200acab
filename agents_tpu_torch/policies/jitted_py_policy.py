"""Host-facing wrapper over a device policy.

Port of ``agents_tpu/policies/jitted_py_policy.py``; the path and class
name are kept so the counterpart is easy to find. The JAX class jits its
action function; this one runs the policy eagerly, op by op. It takes a
numpy time step (from a host env), copies it to the device, acts there
with its own draw source, and returns the action as numpy: the action's
read back is the one host sync of a call. The policy state (a recurrent
carry) stays on the device.
"""
from __future__ import annotations

import torch

from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device
from agents_tpu_torch.utils.draws import as_draws


def to_device(nest, device):
  """A numpy (or tensor) nest as tensors on `device`, copied without a
  host sync (``non_blocking``)."""
  return nest_utils.tree_map(
      lambda x: torch.as_tensor(x).to(device, non_blocking=True), nest)


def to_numpy(nest):
  """A tensor nest read back to numpy (a host sync on the card)."""
  return nest_utils.tree_map(lambda x: x.detach().cpu().numpy(), nest)


class JittedPyPolicy:
  """Args:
    policy: a Policy of the port.
    params: its parameters (`update_params` pulls new ones).
    seed: seeds the draw source, ``Draws(seed, device)``; or a draw source.
    batch_time_steps: if True, adds and strips a leading batch dim of 1
      around each call (for unbatched host envs).
    device: "cuda" unless the caller asks for "cpu".
  """

  def __init__(self, policy, params=None, seed=0,
               batch_time_steps: bool = False, device="cuda"):
    self.device = resolve_device(device)
    self.policy = policy
    self.params = params
    self.batch_time_steps = batch_time_steps
    self.draws = as_draws(seed, self.device)

  def update_params(self, params):
    """Act with `params` from now on."""
    self.params = params

  def init_state(self, batch_size=None):
    return self.policy.init_state(batch_size, device=self.device)

  @torch.no_grad()
  def action(self, time_step: ts.TimeStep, state=()) -> ps.PolicyStep:
    if self.batch_time_steps:
      time_step = nest_utils.batch_nested_array(time_step)
    step = self.policy.action(self.params, to_device(time_step, self.device),
                              state, self.draws)
    action = to_numpy(step.action)
    if self.batch_time_steps:
      action = nest_utils.unbatch_nested_array(action)
    return ps.PolicyStep(action=action, state=step.state, info=step.info)
