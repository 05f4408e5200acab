"""PolicyStep: (action, state, info).

Port of ``agents_tpu/trajectories/policy_step.py`` (`PolicyStep`).
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
