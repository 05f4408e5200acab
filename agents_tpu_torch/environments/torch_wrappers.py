"""Wrappers of batched on-device environments.

Port of ``agents_tpu/environments/jax_wrappers.py``: `TorchEnvironmentWrapper`
delegates every call to the wrapped environment; `OneHotActionTorchWrapper`
exposes a float one-hot action spec ``(K,)`` in [0, 1] over an
environment with a scalar integer action, and steps it with each row's
``argmax + minimum``, so continuous-action machinery (CEM over the one-hot
vector) can drive a discrete environment.
"""
from __future__ import annotations

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec


class TorchEnvironmentWrapper(TorchEnvironment):
  """Delegates everything to the wrapped environment."""

  def __init__(self, env: TorchEnvironment):
    self._env = env

  def __getattr__(self, name):
    if name.startswith("_"):
      raise AttributeError(name)
    return getattr(self._env, name)

  @property
  def wrapped_env(self) -> TorchEnvironment:
    return self._env

  def observation_spec(self):
    return self._env.observation_spec()

  def action_spec(self):
    return self._env.action_spec()

  def reward_spec(self):
    return self._env.reward_spec()

  def reset(self, draws, batch_size: int):
    return self._env.reset(draws, batch_size)

  def step(self, state, action, draws=None):
    return self._env.step(state, action, draws)


class OneHotActionTorchWrapper(TorchEnvironmentWrapper):
  """A one-hot float action spec over a scalar discrete environment."""

  def __init__(self, env: TorchEnvironment):
    super().__init__(env)
    spec = env.action_spec()
    if spec.shape != () or not np.issubdtype(spec.dtype, np.integer):
      raise ValueError(
          f"OneHotActionTorchWrapper needs a scalar integer action spec, "
          f"got {spec}")
    self._minimum = int(spec.minimum)
    self._num_actions = int(spec.maximum) - self._minimum + 1

  def action_spec(self):
    return array_spec.BoundedArraySpec(
        (self._num_actions,), np.float32, 0.0, 1.0, "one_hot_action")

  def step(self, state, action, draws=None):
    index = torch.argmax(action, dim=-1).to(torch.int32) + self._minimum
    return self._env.step(state, index, draws)
