"""Metrics as device-tensor reducers updated inside collection.

Port of ``agents_tpu/metrics/jax_metrics.py`` (`DequeState`,
`EnvironmentSteps`, `NumberOfEpisodes`, `AverageReturnMetric`,
`AverageEpisodeLengthMetric`, `standard_collect_metrics`). Each metric is a
(state, trajectory-frame) -> state reducer over device tensors plus a
`result` readout, so a driver updates them with no host sync. Frames
arrive batched [B]. Counters are int64 (torch's sum type) where the JAX
package keeps int32.
"""
from __future__ import annotations

import dataclasses

import torch

from agents_tpu_torch.trajectories.trajectory import Trajectory


@dataclasses.dataclass(frozen=True)
class DequeState:
  """Fixed-capacity ring of scalars with masked mean/max/min.

  `buffer` holds capacity + 1 slots: the last one absorbs the rows that a
  push drops (torch's scatter has no ``mode="drop"``); `data` is the ring.
  """
  buffer: torch.Tensor  # [capacity + 1]
  count: torch.Tensor   # int64 scalar: total pushes

  @staticmethod
  def create(capacity: int, dtype=torch.float32, device=None) -> "DequeState":
    return DequeState(
        buffer=torch.zeros((capacity + 1,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device))

  @property
  def capacity(self) -> int:
    return self.buffer.shape[0] - 1

  @property
  def data(self) -> torch.Tensor:
    return self.buffer[:-1]

  def push_batch(self, mask, values) -> "DequeState":
    """Push values[i] where mask[i], in row order, as one scatter.

    When more rows are masked in than the ring holds, the LAST `capacity`
    of them are kept: their ranks are consecutive, so their ring slots are
    distinct.
    """
    cap = self.capacity
    mask_i = mask.to(torch.int64)
    rank = torch.cumsum(mask_i, dim=0) - mask_i   # exclusive prefix count
    total = mask_i.sum()
    keep = mask & (rank >= total - cap)
    pos = torch.where(keep, (self.count + rank) % cap, cap)
    buffer = self.buffer.scatter(0, pos, values.to(self.buffer.dtype))
    return DequeState(buffer=buffer, count=self.count + total)

  def _valid(self):
    cap = self.capacity
    n = torch.clamp(self.count, max=cap)
    return torch.arange(cap, device=self.buffer.device) < n, n

  def mean(self):
    mask, n = self._valid()
    total = torch.sum(torch.where(mask, self.data, 0.0))
    return torch.where(n > 0, total / torch.clamp(n, min=1), 0.0)

  def max(self):
    mask, n = self._valid()
    top = torch.max(torch.where(mask, self.data, float("-inf")))
    return torch.where(n > 0, top, 0.0)

  def min(self):
    mask, n = self._valid()
    bottom = torch.min(torch.where(mask, self.data, float("inf")))
    return torch.where(n > 0, bottom, 0.0)


class Metric:
  """Base: init(batch_size, device) -> state; update(state, traj) -> state;
  result(state) -> device scalar."""
  name: str = "metric"

  def init(self, batch_size: int, device=None):
    raise NotImplementedError

  def update(self, state, traj: Trajectory):
    raise NotImplementedError

  def result(self, state):
    raise NotImplementedError


class EnvironmentSteps(Metric):
  """Counts non-boundary frames."""
  name = "EnvironmentSteps"

  def init(self, batch_size: int, device=None):
    return torch.zeros((), dtype=torch.int64, device=device)

  def update(self, state, traj):
    return state + torch.sum(~traj.is_boundary())

  def result(self, state):
    return state


class NumberOfEpisodes(Metric):
  """Counts completed episodes (LAST frames)."""
  name = "NumberOfEpisodes"

  def init(self, batch_size: int, device=None):
    return torch.zeros((), dtype=torch.int64, device=device)

  def update(self, state, traj):
    return state + torch.sum(traj.is_last())

  def result(self, state):
    return state


@dataclasses.dataclass(frozen=True)
class _ReturnAccumulatorState:
  accumulator: torch.Tensor  # [B] running per-row value
  deque: DequeState


class AverageReturnMetric(Metric):
  """Mean undiscounted episode return over the last `buffer_size` episodes.
  Accumulates reward per env row; on is_last pushes the row's return and
  zeroes the row. Boundary frames carry no reward."""
  name = "AverageReturn"

  def __init__(self, buffer_size: int = 10):
    self.buffer_size = buffer_size

  def init(self, batch_size: int, device=None):
    return _ReturnAccumulatorState(
        accumulator=torch.zeros((batch_size,), dtype=torch.float32,
                                device=device),
        deque=DequeState.create(self.buffer_size, device=device))

  def _increment(self, traj, not_boundary):
    return traj.reward * not_boundary

  def update(self, state, traj):
    not_boundary = (~traj.is_boundary()).to(torch.float32)
    acc = state.accumulator + self._increment(traj, not_boundary)
    done = traj.is_last()
    deque = state.deque.push_batch(done, acc)
    acc = torch.where(done, 0.0, acc)
    return _ReturnAccumulatorState(accumulator=acc, deque=deque)

  def result(self, state):
    return state.deque.mean()


class AverageEpisodeLengthMetric(AverageReturnMetric):
  """Mean episode length over the last `buffer_size` episodes."""
  name = "AverageEpisodeLength"

  def _increment(self, traj, not_boundary):
    return not_boundary


def standard_collect_metrics(buffer_size: int = 10):
  """EnvironmentSteps, NumberOfEpisodes, AverageReturn and
  AverageEpisodeLength."""
  return (EnvironmentSteps(), NumberOfEpisodes(),
          AverageReturnMetric(buffer_size),
          AverageEpisodeLengthMetric(buffer_size))
