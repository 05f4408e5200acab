"""dm_control suite loader (standalone module for reference parity).

Port of ``agents_tpu/environments/suite_dm_control.py`` (the reference's
``tf_agents/environments/suite_dm_control.py:30-136``). The
implementation lives in ``environments/suites.py`` (shared dm_env
adapter machinery); this module mirrors the reference's import surface
(``suite_dm_control.load`` / ``load_pixels`` / ``is_available``) and
adds the pixel-observation variant. Held against the JAX module on the
real dm_control backend in ``tests/test_torch_dm_env.py``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from agents_tpu_torch.environments.suites import (is_dm_control_available,
                                            load_dm_control, wrap_dm_env)

is_available = is_dm_control_available


def load(domain_name: str, task_name: str,
         task_kwargs: Optional[dict] = None,
         environment_kwargs: Optional[dict] = None,
         env_wrappers: Sequence[Callable] = (),
         render_kwargs: Optional[dict] = None):
  """Load a dm_control suite task as a PyEnvironment
  (reference suite_dm_control.load :30; float64 specs demoted and dict
  observations preserved by DmEnvWrapper/convert_spec)."""
  return load_dm_control(domain_name, task_name, task_kwargs=task_kwargs,
                         environment_kwargs=environment_kwargs,
                         env_wrappers=env_wrappers,
                         render_kwargs=render_kwargs)


def load_pixels(domain_name: str, task_name: str,
                render_kwargs: Optional[dict] = None,
                env_wrappers: Sequence[Callable] = (), **kwargs):
  """Pixel-observation variant (reference load_pixels :83): wraps the
  task with dm_control.suite.wrappers.pixels (headless rendering —
  set MUJOCO_GL=egl on GPU-less hosts)."""
  if not is_dm_control_available():
    raise ImportError(
        "dm_control is not installed; suite_dm_control.load_pixels "
        "requires it (pip install dm_control).")
  from dm_control import suite
  from dm_control.suite.wrappers import pixels
  env = suite.load(domain_name, task_name, **kwargs)
  env = pixels.Wrapper(env, render_kwargs=render_kwargs)
  return wrap_dm_env(env, env_wrappers=env_wrappers)
