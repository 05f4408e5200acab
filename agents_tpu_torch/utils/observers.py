"""Observer adapters.

Port of ``agents_tpu/utils/observers.py`` (the reference's
``tf_agents/utils/batched_observer_unbatching.py:42``): delegate batched
trajectories row by row to per-env observers that do not understand batch
dimensions (e.g. per-episode dataset writers keyed by env instance).
Rows are indexed as they are, numpy arrays or tensors.
"""
from __future__ import annotations

from typing import Callable

from agents_tpu_torch.utils import nest_utils


class BatchedObserverUnbatching:
  """Fan a batched trajectory out to `batch_size` unbatched observers.

  One delegated observer is created per batch row via
  `create_delegated_observer_fn`, so stateful observers (episode
  accumulators, file writers) track a single env's stream each (batch
  size fixed, not validated, as in the reference).
  """

  def __init__(self,
               create_delegated_observer_fn: Callable[[], Callable],
               batch_size: int):
    if batch_size < 1:
      raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    self._delegated_observers = [
        create_delegated_observer_fn() for _ in range(batch_size)
    ]

  @property
  def delegated_observers(self):
    return tuple(self._delegated_observers)

  def __call__(self, batched_trajectory):
    for i, obs in enumerate(self._delegated_observers):
      obs(nest_utils.tree_map(lambda x: x[i], batched_trajectory))
