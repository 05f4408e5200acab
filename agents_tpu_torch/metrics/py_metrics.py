"""Numpy metrics for host drivers and host loops.

Port of ``agents_tpu/metrics/py_metrics.py``: `NumpyDeque`,
`StreamingMetric`, `AverageReturnMetric`, `AverageEpisodeLengthMetric`,
`EnvironmentSteps` and `NumberOfEpisodes`, each with `get_state` and
`set_state` (plain numbers and lists). `fixed_shape_states` and
`load_fixed_shape_states` turn the states of a list of metrics into
tensors of fixed shapes and back, so that a loop's checkpoint template
(`train/checkpointer.py`) can hold them. A metric is called with a numpy
Trajectory frame, batched or not.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from agents_tpu_torch.trajectories import time_step as ts


class PyMetric:
  name = "py_metric"

  def __call__(self, traj):
    raise NotImplementedError

  def result(self):
    raise NotImplementedError

  def reset(self):
    raise NotImplementedError

  # Metric state that a checkpoint carries; JSON-serializable.
  def get_state(self):
    return {}

  def set_state(self, state):
    del state


class NumpyDeque:
  """A bounded deque of numbers with numpy reductions."""

  def __init__(self, maxlen: int, dtype=np.float64):
    self._deque = collections.deque(maxlen=maxlen)
    self._dtype = dtype

  def add(self, value):
    self._deque.append(value)

  def extend(self, values):
    self._deque.extend(values)

  def clear(self):
    self._deque.clear()

  def __len__(self):
    return len(self._deque)

  def mean(self, default=0.0):
    return np.mean(self._deque) if self._deque else default

  def max(self, default=0.0):
    return np.max(self._deque) if self._deque else default

  def min(self, default=0.0):
    return np.min(self._deque) if self._deque else default


class StreamingMetric(PyMetric):
  """Per-row accumulators and a deque of finished episodes' values."""

  def __init__(self, name, buffer_size: int = 10,
               batch_size: Optional[int] = None):
    self.name = name
    self._buffer = NumpyDeque(buffer_size)
    self._batch_size = batch_size
    self.reset()

  def reset(self):
    self._buffer.clear()
    self._acc = None

  def _ensure_acc(self, batch_size):
    if self._acc is None:
      self._acc = np.zeros(batch_size, np.float64)

  def __call__(self, traj):
    step_type = np.atleast_1d(np.asarray(traj.step_type))
    next_step_type = np.atleast_1d(np.asarray(traj.next_step_type))
    reward = np.atleast_1d(np.asarray(traj.reward))
    self._ensure_acc(len(step_type))
    is_boundary = step_type == ts.StepType.LAST
    self._update(reward, is_boundary)
    done = next_step_type == ts.StepType.LAST
    for i in np.where(done)[0]:
      self._buffer.add(self._acc[i])
      self._acc[i] = 0.0

  def _update(self, reward, is_boundary):
    raise NotImplementedError

  def result(self):
    return float(self._buffer.mean())

  def get_state(self):
    # The per-row accumulators are not saved: on resume the host envs
    # restart from reset (a preempted run loses its episodes in flight),
    # so a restored accumulator would credit the old half-episode to the
    # new one.
    return {"buffer": [float(v) for v in self._buffer._deque]}

  def set_state(self, state):
    self.reset()
    self._buffer.extend(state.get("buffer", []))


class AverageReturnMetric(StreamingMetric):

  def __init__(self, buffer_size: int = 10, batch_size=None):
    super().__init__("AverageReturn", buffer_size, batch_size)

  def _update(self, reward, is_boundary):
    self._acc += np.where(is_boundary, 0.0, reward)


class AverageEpisodeLengthMetric(StreamingMetric):

  def __init__(self, buffer_size: int = 10, batch_size=None):
    super().__init__("AverageEpisodeLength", buffer_size, batch_size)

  def _update(self, reward, is_boundary):
    self._acc += np.where(is_boundary, 0.0, 1.0)


class EnvironmentSteps(PyMetric):

  def __init__(self):
    self.name = "EnvironmentSteps"
    self.count = 0

  def reset(self):
    self.count = 0

  def __call__(self, traj):
    step_type = np.atleast_1d(np.asarray(traj.step_type))
    self.count += int(np.sum(step_type != ts.StepType.LAST))

  def result(self):
    return self.count

  def get_state(self):
    return {"count": self.count}

  def set_state(self, state):
    self.count = int(state.get("count", 0))


class NumberOfEpisodes(PyMetric):

  def __init__(self):
    self.name = "NumberOfEpisodes"
    self.count = 0

  def reset(self):
    self.count = 0

  def __call__(self, traj):
    next_step_type = np.atleast_1d(np.asarray(traj.next_step_type))
    self.count += int(np.sum(next_step_type == ts.StepType.LAST))

  def result(self):
    return self.count

  def get_state(self):
    return {"count": self.count}

  def set_state(self, state):
    self.count = int(state.get("count", 0))


def fixed_shape_states(metrics):
  """The metrics' states as fixed-shape values: a deque's buffer as a
  float64 tensor padded to its maxlen, with its length; a count as an
  int."""
  out = []
  for m in metrics:
    st = m.get_state() if hasattr(m, "get_state") else {}
    if "buffer" in st:
      buf = torch.zeros((m._buffer._deque.maxlen,), dtype=torch.float64)
      vals = st["buffer"]
      buf[:len(vals)] = torch.tensor(vals, dtype=torch.float64)
      out.append({"buffer": buf, "n": len(vals)})
    else:
      out.append({"count": int(st.get("count", 0))})
  return tuple(out)


def load_fixed_shape_states(metrics, saved) -> None:
  """Set the metrics' states from `fixed_shape_states`' output."""
  for m, st in zip(metrics, saved):
    if not hasattr(m, "set_state"):
      continue
    if "buffer" in st:
      m.set_state({"buffer": [float(v) for v in st["buffer"][:st["n"]]]})
    else:
      m.set_state({"count": int(st["count"])})
