"""Metrics as device-tensor reducers updated inside collection.

Port of ``agents_tpu/metrics/jax_metrics.py`` (`DequeState`,
`EnvironmentSteps`, `NumberOfEpisodes`, `AverageReturnMetric`,
`MaxReturnMetric`, `MinReturnMetric`, `AverageEpisodeLengthMetric`,
`AverageReturnMultiMetric`, `ChosenActionHistogram`,
`standard_collect_metrics`). Each metric is a
(state, trajectory-frame) -> state reducer over device tensors plus a
`result` readout, so a driver updates them with no host sync. Frames
arrive batched [B]. Counters are int64 (torch's sum type) where the JAX
package keeps int32.

Over a data-parallel mesh (``update(state, traj, mesh)``, the loops built
with a mesh) each rank sees its own rows, while the JAX package keeps the
deques and counters replicated and feeds them from every row: a counter
adds the sum over the ranks (one all-reduce), and a deque metric
all-gathers each row's episode end and value in rank order, so every
rank pushes what the JAX deque pushes. Per-row accumulators stay local.
"""
from __future__ import annotations

import dataclasses

import torch

from agents_tpu_torch.trajectories.trajectory import Trajectory


@dataclasses.dataclass(frozen=True)
class DequeState:
  """Fixed-capacity ring of scalars with masked mean/max/min.

  `buffer` holds capacity + 1 slots: the last one absorbs the rows that a
  push drops (torch's scatter has no ``mode="drop"``), as zeros, so that
  slot does not depend on the order in which the card writes them (a
  checkpoint compares whole states); `data` is the ring.
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

  def add(self, value) -> "DequeState":
    """Push one scalar."""
    return self.add_where(torch.ones((), dtype=torch.bool,
                                     device=self.buffer.device), value)

  def add_where(self, cond, value) -> "DequeState":
    """Push one scalar where the scalar `cond` holds (the slot keeps its
    value and the count stays where it does not)."""
    idx = (self.count % self.capacity).reshape(1)
    value = torch.as_tensor(value, dtype=self.buffer.dtype,
                            device=self.buffer.device)
    new = torch.where(cond, value, self.buffer.index_select(0, idx)[0])
    return DequeState(buffer=self.buffer.index_copy(0, idx, new.reshape(1)),
                      count=self.count + cond.to(torch.int64))

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
    values = torch.where(keep, values.to(self.buffer.dtype), 0)
    buffer = self.buffer.scatter(0, pos, values)
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


def _row_sum(x, mesh):
  """Sum over the rows of every rank."""
  total = torch.sum(x, dim=0)
  return total if mesh is None else mesh.all_reduce(total)


def _every_row(done, values, mesh):
  """(done, values) of every rank's rows, in rank order: one all-gather of
  the two packed as float32 (values [B] or [B, k])."""
  if mesh is None:
    return done, values
  v = values.reshape(values.shape[0], -1).float()
  packed = mesh.all_gather_rows(torch.cat([done.float()[:, None], v], 1))
  return (packed[:, 0] > 0.5,
          packed[:, 1:].reshape((-1,) + tuple(values.shape[1:])))


class Metric:
  """Base: init(batch_size, device) -> state; update(state, traj[, mesh])
  -> state; result(state) -> device scalar. `result_kind` says what
  `result` returns: "scalar", or "counts" (a 1-D vector of per-bucket
  counts, `ChosenActionHistogram`); summary writers route on it."""
  name: str = "metric"
  result_kind: str = "scalar"

  def init(self, batch_size: int, device=None):
    raise NotImplementedError

  def update(self, state, traj: Trajectory, mesh=None):
    raise NotImplementedError

  def result(self, state):
    raise NotImplementedError

  def __call__(self, state, traj: Trajectory, mesh=None):
    return self.update(state, traj, mesh)


class EnvironmentSteps(Metric):
  """Counts non-boundary frames."""
  name = "EnvironmentSteps"

  def init(self, batch_size: int, device=None):
    return torch.zeros((), dtype=torch.int64, device=device)

  def update(self, state, traj, mesh=None):
    return state + _row_sum(~traj.is_boundary(), mesh)

  def result(self, state):
    return state


class NumberOfEpisodes(Metric):
  """Counts completed episodes (LAST frames)."""
  name = "NumberOfEpisodes"

  def init(self, batch_size: int, device=None):
    return torch.zeros((), dtype=torch.int64, device=device)

  def update(self, state, traj, mesh=None):
    return state + _row_sum(traj.is_last(), mesh)

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

  def update(self, state, traj, mesh=None):
    not_boundary = (~traj.is_boundary()).to(torch.float32)
    acc = state.accumulator + self._increment(traj, not_boundary)
    done = traj.is_last()
    deque = state.deque.push_batch(*_every_row(done, acc, mesh))
    acc = torch.where(done, 0.0, acc)
    return _ReturnAccumulatorState(accumulator=acc, deque=deque)

  def result(self, state):
    return state.deque.mean()


class MaxReturnMetric(AverageReturnMetric):
  """Largest episode return over the last `buffer_size` episodes."""
  name = "MaxReturn"

  def result(self, state):
    return state.deque.max()


class MinReturnMetric(AverageReturnMetric):
  """Smallest episode return over the last `buffer_size` episodes."""
  name = "MinReturn"

  def result(self, state):
    return state.deque.min()


class AverageEpisodeLengthMetric(AverageReturnMetric):
  """Mean episode length over the last `buffer_size` episodes."""
  name = "AverageEpisodeLength"

  def _increment(self, traj, not_boundary):
    return not_boundary


@dataclasses.dataclass(frozen=True)
class _MultiReturnState:
  accumulator: torch.Tensor  # [B, reward_len]
  deques: tuple              # one DequeState per reward component


class AverageReturnMultiMetric(Metric):
  """Per-component mean return of vector rewards ``[B, reward_len]``: one
  deque per component, all pushed with the same done mask. The result is
  ``[reward_len]``."""
  name = "AverageReturnMulti"

  def __init__(self, reward_len: int, buffer_size: int = 10):
    self.reward_len = reward_len
    self.buffer_size = buffer_size

  def init(self, batch_size: int, device=None):
    return _MultiReturnState(
        accumulator=torch.zeros((batch_size, self.reward_len),
                                dtype=torch.float32, device=device),
        deques=tuple(DequeState.create(self.buffer_size, device=device)
                     for _ in range(self.reward_len)))

  def update(self, state, traj, mesh=None):
    not_boundary = (~traj.is_boundary()).to(torch.float32)
    acc = state.accumulator + traj.reward * not_boundary[..., None]
    done = traj.is_last()
    all_done, all_acc = _every_row(done, acc, mesh)
    deques = tuple(dq.push_batch(all_done, all_acc[:, i])
                   for i, dq in enumerate(state.deques))
    acc = torch.where(done[..., None], 0.0, acc)
    return _MultiReturnState(accumulator=acc, deques=deques)

  def result(self, state):
    return torch.stack([dq.mean() for dq in state.deques])


class ChosenActionHistogram(Metric):
  """Counts of each discrete action over non-boundary frames
  ``[num_actions]`` (int64). `result_kind` "counts" tells a summary
  writer to draw it as a histogram."""
  name = "ChosenActionHistogram"
  result_kind = "counts"

  def __init__(self, num_actions: int):
    self.num_actions = num_actions

  def init(self, batch_size: int, device=None):
    return torch.zeros((self.num_actions,), dtype=torch.int64, device=device)

  def update(self, state, traj, mesh=None):
    # Boundary frames carry no chosen action. The one-hot is a comparison
    # with an arange: `F.one_hot` checks its bounds with a host sync.
    valid = ~traj.is_boundary()
    actions = torch.arange(self.num_actions, device=state.device)
    onehot = traj.action.to(torch.int64)[:, None] == actions
    return state + _row_sum((onehot & valid[:, None]).to(torch.int64), mesh)

  def result(self, state):
    return state


def standard_collect_metrics(buffer_size: int = 10):
  """EnvironmentSteps, NumberOfEpisodes, AverageReturn and
  AverageEpisodeLength."""
  return (EnvironmentSteps(), NumberOfEpisodes(),
          AverageReturnMetric(buffer_size),
          AverageEpisodeLengthMetric(buffer_size))
