"""Training coordination utilities.

Port of ``agents_tpu/train/train_utils.py``: `wait_for_predicate`,
`wait_for_file`, `wait_for_policy` (the eval job's polling) and
`get_specs_from_env`.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Callable, Optional


def wait_for_predicate(predicate: Callable[[], bool],
                       sleep_time_secs: float = 0.5,
                       timeout_secs: Optional[float] = 60.0) -> bool:
  """Polls until `predicate()` holds (True) or the timeout ends (False);
  `timeout_secs=None` waits forever."""
  t0 = time.time()
  while not predicate():
    if timeout_secs is not None and time.time() - t0 > timeout_secs:
      return False
    time.sleep(sleep_time_secs)
  return True


def wait_for_file(file_pattern: str, sleep_time_secs: float = 0.5,
                  timeout_secs: Optional[float] = 60.0) -> Optional[str]:
  """The last (sorted) file matching the glob `file_pattern`, once one
  exists; None at the timeout."""
  found = []

  def check():
    found[:] = glob.glob(file_pattern)
    return bool(found)

  if wait_for_predicate(check, sleep_time_secs, timeout_secs):
    return sorted(found)[-1]
  return None


def wait_for_policy(policy_dir: str, sleep_time_secs: float = 0.5,
                    timeout_secs: Optional[float] = 60.0) -> Optional[str]:
  """`policy_dir` once it holds an exported policy's manifest; None at the
  timeout."""
  manifest = wait_for_file(
      os.path.join(policy_dir, "policy_manifest.json"),
      sleep_time_secs, timeout_secs)
  return os.path.dirname(manifest) if manifest else None


def get_specs_from_env(env):
  """(observation, action, time_step) specs of `env`."""
  return env.observation_spec(), env.action_spec(), env.time_step_spec()
