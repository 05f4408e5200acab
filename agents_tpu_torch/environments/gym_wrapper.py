"""Gymnasium adapter.

Port of ``agents_tpu/environments/gym_wrapper.py``: `spec_from_gym_space`
and `GymWrapper`. gymnasium is imported inside the functions that need it,
so the package imports on a machine without it.
"""
from __future__ import annotations

import numpy as np

from agents_tpu_torch.environments.py_environment import (PyEnvironment,
                                                          np_restart,
                                                          np_termination,
                                                          np_transition,
                                                          np_truncation)
from agents_tpu_torch.specs import array_spec


def spec_from_gym_space(space, name: str = "observation",
                        float_dtype=np.float32):
  """A gymnasium space as a spec nest; float Boxes are cast to
  `float_dtype` (float32 unless None)."""
  import gymnasium as gym

  if isinstance(space, gym.spaces.Discrete):
    return array_spec.BoundedArraySpec(
        (), np.int64, minimum=int(space.start),
        maximum=int(space.start + space.n - 1), name=name)
  if isinstance(space, gym.spaces.MultiDiscrete):
    return array_spec.BoundedArraySpec(
        space.shape, np.int32, minimum=0,
        maximum=np.asarray(space.nvec) - 1, name=name)
  if isinstance(space, gym.spaces.MultiBinary):
    return array_spec.BoundedArraySpec(
        tuple(np.atleast_1d(space.n)), np.int8, minimum=0, maximum=1,
        name=name)
  if isinstance(space, gym.spaces.Box):
    dtype = space.dtype
    if np.issubdtype(dtype, np.floating) and float_dtype is not None:
      dtype = float_dtype
    return array_spec.BoundedArraySpec(
        space.shape, dtype, minimum=space.low.astype(dtype),
        maximum=space.high.astype(dtype), name=name)
  if isinstance(space, gym.spaces.Tuple):
    return tuple(spec_from_gym_space(s, f"{name}/{i}", float_dtype)
                 for i, s in enumerate(space.spaces))
  if isinstance(space, gym.spaces.Dict):
    return {k: spec_from_gym_space(s, f"{name}/{k}", float_dtype)
            for k, s in space.spaces.items()}
  raise ValueError(f"Unsupported gym space: {space}")


class GymWrapper(PyEnvironment):
  """A gymnasium.Env as a PyEnvironment: terminated -> LAST with discount
  0, truncated -> LAST with discount `discount`."""

  def __init__(self, gym_env, discount: float = 1.0,
               auto_reset: bool = True):
    super().__init__(handle_auto_reset=auto_reset)
    self._gym_env = gym_env
    self._discount = discount
    self._observation_spec = spec_from_gym_space(
        gym_env.observation_space, "observation")
    self._action_spec = spec_from_gym_space(gym_env.action_space, "action")

  @property
  def gym(self):
    return self._gym_env

  def observation_spec(self):
    return self._observation_spec

  def action_spec(self):
    return self._action_spec

  def _cast(self, obs):
    return array_spec.map_spec_nest(lambda s, x: np.asarray(x, s.dtype),
                                    self._observation_spec, obs)

  def _reset(self):
    obs, _ = self._gym_env.reset()
    return np_restart(self._cast(obs))

  def _step(self, action):
    action = np.asarray(action)
    if isinstance(self._action_spec, array_spec.BoundedArraySpec) and \
        self._action_spec.shape == () and action.shape == ():
      action = action.item()
    obs, reward, terminated, truncated, _ = self._gym_env.step(action)
    obs = self._cast(obs)
    reward = np.asarray(reward, np.float32)
    if terminated:
      return np_termination(obs, reward)
    if truncated:
      return np_truncation(obs, reward, self._discount)
    return np_transition(obs, reward, self._discount)

  def render(self, mode="rgb_array"):
    return self._gym_env.render()

  def seed(self, seed):
    self._gym_env.reset(seed=int(seed))

  def close(self):
    self._gym_env.close()

  def get_info(self):
    return None
