"""PolicyStep: (action, state, info), and the log-probability info.

Port of ``agents_tpu/trajectories/policy_step.py``: `PolicyStep`,
`PolicyInfo`, `set_log_probability` and `get_log_probability`.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class PolicyStep:
  action: Any = ()
  state: Any = ()
  info: Any = ()

  def replace(self, **kwargs) -> "PolicyStep":
    return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class PolicyInfo:
  """The standard info payload."""
  log_probability: Any = ()


def set_log_probability(info, log_probability):
  if info == () or info is None:
    return PolicyInfo(log_probability=log_probability)
  if isinstance(info, PolicyInfo):
    return dataclasses.replace(info, log_probability=log_probability)
  if isinstance(info, dict):
    return {**info, "log_probability": log_probability}
  raise TypeError(f"Cannot set log_probability on info of type {type(info)}")


def get_log_probability(info):
  if isinstance(info, PolicyInfo):
    return info.log_probability
  if isinstance(info, dict):
    return info["log_probability"]
  raise TypeError(f"No log_probability in info of type {type(info)}")
