"""Optional environment suites.

Port of ``agents_tpu/environments/suites.py`` (the reference's
``tf_agents/environments/suite_{atari,dm_control,pybullet,bsuite}.py``). Like the reference, each suite is gated on its backend being
importable and raises a clear error otherwise (the reference pattern of
`suite_x.is_available()`).

Atari preprocessing (Mnih et al. 2015: frame-skip 4 with max-pooling,
grayscale 84x84 resize, frame stack) mirrors
``environments/atari_preprocessing.py:40`` + ``atari_wrappers.py`` and is
implemented via gymnasium's AtariPreprocessing + the port's
HistoryWrapper. The environments are host (numpy) environments; the host
loops copy their time steps to the card.
"""
from __future__ import annotations

from typing import Optional, Sequence


def _missing(name, package):
  raise ImportError(
      f"suite_{name} requires the '{package}' backend which is not "
      f"installed. Install it or use suite_gym / the device "
      f"environments.")


def is_atari_available() -> bool:
  try:
    import ale_py  # noqa: F401
    return True
  except ImportError:
    return False


def load_atari(game: str = "PongNoFrameskip-v4",
               max_episode_steps: Optional[int] = 108000 // 4,
               frame_stack: int = 4):
  """DQN-paper preprocessing (suite_atari.py + atari_preprocessing.py):
  observations [84, 84, frame_stack] uint8."""
  if not is_atari_available():
    _missing("atari", "ale-py")
  import gymnasium as gym

  from agents_tpu_torch.environments import wrappers
  from agents_tpu_torch.environments.gym_wrapper import GymWrapper

  env = gym.make(game, frameskip=1)
  # grayscale_newaxis keeps each frame [84, 84, 1], so HistoryWrapper
  # stacks the frames as channels: [84, 84, 4] uint8. (The JAX package
  # leaves it at gymnasium's default, whose [84, 84] frames stack to
  # [84, 336].)
  env = gym.wrappers.AtariPreprocessing(
      env, frame_skip=4, screen_size=84, grayscale_obs=True,
      grayscale_newaxis=True, scale_obs=False)
  py_env = GymWrapper(env)
  if max_episode_steps:
    py_env = wrappers.TimeLimit(py_env, max_episode_steps)
  if frame_stack > 1:
    # Atari-style stacking tiles the first frame (reference FrameStack4,
    # atari_wrappers.py:31); HistoryWrapper's own default (False)
    # zero-pads like the reference HistoryWrapper (wrappers.py:1029).
    py_env = wrappers.HistoryWrapper(py_env, history_length=frame_stack,
                                     tile_first_step_obs=True)
  return py_env


def is_dm_control_available() -> bool:
  try:
    import dm_control  # noqa: F401
    return True
  except ImportError:
    return False


def load_dm_control(domain_name: str, task_name: str, task_kwargs=None,
                    environment_kwargs=None, visualize_reward: bool = False,
                    render_kwargs=None, env_wrappers: Sequence = ()):
  """dm_control suite loader (reference suite_dm_control.py:33-136):
  ``dm_control.suite.load`` -> DmEnvWrapper -> optional extra wrappers."""
  if not is_dm_control_available():
    _missing("dm_control", "dm-control")
  from dm_control import suite as dm_suite  # type: ignore

  dmc_env = dm_suite.load(domain_name, task_name, task_kwargs=task_kwargs,
                          environment_kwargs=environment_kwargs,
                          visualize_reward=visualize_reward)
  return wrap_dm_env(dmc_env, render_kwargs=render_kwargs,
                     env_wrappers=env_wrappers)


def wrap_dm_env(dm_env_instance, render_kwargs=None,
                env_wrappers: Sequence = (),
                flatten_observations: bool = False):
  """Adapt any dm_env.Environment-conforming object (dm_control, bsuite,
  custom) to a PyEnvironment. Separated from the loaders so the adapter
  is testable against fake dm_env classes without the backends."""
  from agents_tpu_torch.environments import wrappers
  from agents_tpu_torch.environments.dm_env_wrapper import DmEnvWrapper

  env = DmEnvWrapper(dm_env_instance, render_kwargs=render_kwargs)
  if flatten_observations:
    env = wrappers.FlattenObservationsWrapper(env)
  for wrapper in env_wrappers:
    env = wrapper(env)
  return env


def is_pybullet_available() -> bool:
  try:
    import pybullet_envs  # noqa: F401
    return True
  except ImportError:
    return False


def load_pybullet(env_name: str, **kwargs):
  if not is_pybullet_available():
    _missing("pybullet", "pybullet")
  from agents_tpu_torch.environments import suite_gym

  return suite_gym.load(env_name, **kwargs)


def is_bsuite_available() -> bool:
  try:
    import bsuite  # noqa: F401
    return True
  except ImportError:
    return False


def load_bsuite(bsuite_id: str, record: bool = False,
                save_path: Optional[str] = None,
                logging_mode: str = "csv", overwrite: bool = False,
                env_wrappers: Sequence = ()):
  """bsuite loader (reference suite_bsuite.py:30-90). bsuite environments
  speak dm_env, so they go through the same DmEnvWrapper adapter."""
  if not is_bsuite_available():
    _missing("bsuite", "bsuite")
  import bsuite  # type: ignore

  if record:
    raw_env = bsuite.load_and_record(bsuite_id=bsuite_id,
                                     save_path=save_path,
                                     logging_mode=logging_mode,
                                     overwrite=overwrite)
  else:
    raw_env = bsuite.load_from_id(bsuite_id=bsuite_id)
  return wrap_dm_env(raw_env, env_wrappers=env_wrappers)
