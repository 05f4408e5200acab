"""Per-arm observation spec helpers.

Port of ``agents_tpu/bandits/specs/bandit_spec_utils.py``: per-arm bandit
observations are dicts {GLOBAL_FEATURE_KEY: [g], PER_ARM_FEATURE_KEY:
[K, a], NUM_ACTIONS_FEATURE_KEY: []} (the last optional, for variable arm
counts). A dict with all three keys holds them in sorted-key order
(global, num_actions, per_arm), the order in which the JAX package walks a
dict, so the port's networks (which join leaves in insertion order) join
them as the JAX networks do.
"""
from __future__ import annotations

import numpy as np

from agents_tpu_torch.specs import array_spec

GLOBAL_FEATURE_KEY = "global"
PER_ARM_FEATURE_KEY = "per_arm"
NUM_ACTIONS_FEATURE_KEY = "num_actions"
# Multi-signal reward dicts (constrained agents): reward becomes
# {REWARD_SPEC_KEY: [B], CONSTRAINTS_SPEC_KEY: [B, num_constraints]}.
REWARD_SPEC_KEY = "reward"
CONSTRAINTS_SPEC_KEY = "constraint"


def create_per_arm_observation_spec(global_dim: int, per_arm_dim: int,
                                    max_num_actions: int,
                                    add_num_actions_feature: bool = False):
  spec = {
      GLOBAL_FEATURE_KEY:
          array_spec.ArraySpec((global_dim,), np.float32, "global"),
      PER_ARM_FEATURE_KEY:
          array_spec.ArraySpec((max_num_actions, per_arm_dim), np.float32,
                               "per_arm"),
  }
  if add_num_actions_feature:
    spec[NUM_ACTIONS_FEATURE_KEY] = array_spec.BoundedArraySpec(
        (), np.int32, 1, max_num_actions, "num_actions")
  return dict(sorted(spec.items()))


def get_context_dims_from_spec(observation_spec):
  g = observation_spec[GLOBAL_FEATURE_KEY].shape[0]
  k, a = observation_spec[PER_ARM_FEATURE_KEY].shape
  return g, k, a
