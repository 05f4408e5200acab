"""Gymnasium environment suite (MuJoCo tasks included).

Port of ``agents_tpu/environments/suite_gym.py``: `load` and `wrap_env`.
``load("HalfCheetah-v5")`` builds a MuJoCo task, gymnasium shipping them.
gymnasium is imported inside `load` only.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from agents_tpu_torch.environments import wrappers as wrappers_lib
from agents_tpu_torch.environments.gym_wrapper import GymWrapper


def load(environment_name: str,
         discount: float = 1.0,
         max_episode_steps: Optional[int] = None,
         gym_env_wrappers: Sequence[Callable] = (),
         env_wrappers: Sequence[Callable] = (),
         gym_kwargs: Optional[dict] = None):
  """A gymnasium env wrapped as a PyEnvironment. `max_episode_steps=None`
  takes the registry's limit, 0 none; the limit is this package's
  `TimeLimit`, gymnasium's own being stripped."""
  import gymnasium as gym

  gym_kwargs = gym_kwargs or {}
  spec = gym.spec(environment_name)
  if max_episode_steps is None and spec.max_episode_steps is not None:
    max_episode_steps = spec.max_episode_steps
  gym_env = spec.make(disable_env_checker=True, **gym_kwargs)
  while hasattr(gym_env, "env") and type(gym_env).__name__ in (
      "TimeLimit", "OrderEnforcing", "PassiveEnvChecker"):
    gym_env = gym_env.env
  return wrap_env(gym_env, discount=discount,
                  max_episode_steps=max_episode_steps,
                  gym_env_wrappers=gym_env_wrappers,
                  env_wrappers=env_wrappers)


def wrap_env(gym_env,
             discount: float = 1.0,
             max_episode_steps: Optional[int] = None,
             gym_env_wrappers: Sequence[Callable] = (),
             env_wrappers: Sequence[Callable] = (),
             auto_reset: bool = True):
  """`gym_env` through `gym_env_wrappers`, `GymWrapper`, a `TimeLimit`
  of `max_episode_steps` (when set) and `env_wrappers`."""
  for w in gym_env_wrappers:
    gym_env = w(gym_env)
  env = GymWrapper(gym_env, discount=discount, auto_reset=auto_reset)
  if max_episode_steps:
    env = wrappers_lib.TimeLimit(env, max_episode_steps)
  for w in env_wrappers:
    env = w(env)
  return env
