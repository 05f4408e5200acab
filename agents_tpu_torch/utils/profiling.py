"""Profiling and timing utilities.

Port of ``agents_tpu/utils/profiling.py``: `trace(log_dir)` captures a
device trace, `annotate(name)` names a host span on its timeline, and
`Timer` is the cumulative wall-clock timer of the reference's
``utils/timer.py``. The JAX package wraps ``jax.profiler``; here `trace`
runs `torch.profiler` over the CPU and, when a card is present, CUDA
activities and writes a chrome trace (viewable in Perfetto or
``chrome://tracing``) under `log_dir`, and `annotate` is
``torch.profiler.record_function`` plus an NVTX range while CUDA is
initialized.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
  """Capture a `torch.profiler` trace of the block into
  ``log_dir/trace.json``.

  Usage:
    with profiling.trace("runs/trace") as prof:
      state, losses = loop.run(state, 20)
      torch.cuda.synchronize()

  Yields the `torch.profiler.profile` object (its `key_averages()` and
  `events()` are read after the block). It traces the CPU and, where a
  card is present, CUDA.
  """
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class annotate(contextlib.ContextDecorator):  # noqa: N801 (the JAX name)
  """A named host span on the profiler timeline, usable as a decorator or
  a context manager; an NVTX range too while CUDA is initialized."""

  def __init__(self, name: str):
    self.name = name
    self._open = []   # (span, nvtx pushed) per entry: a decorated
                      # function may re-enter

  def __enter__(self):
    span = record_function(self.name)
    span.__enter__()
    nvtx = torch.cuda.is_initialized()
    if nvtx:
      torch.cuda.nvtx.range_push(self.name)
    self._open.append((span, nvtx))
    return self

  def __exit__(self, *exc):
    span, nvtx = self._open.pop()
    if nvtx:
      torch.cuda.nvtx.range_pop()
    span.__exit__(*exc)
    return False


class Timer:
  """Cumulative wall-clock timer: `with t:` accumulates; value() returns
  seconds; also usable un-nested via start/stop."""

  def __init__(self):
    self._total = 0.0
    self._start: Optional[float] = None
    self._laps = 0

  def __enter__(self):
    self.start()
    return self

  def __exit__(self, *exc):
    self.stop()
    return False

  def start(self):
    self._start = time.perf_counter()

  def stop(self):
    if self._start is not None:
      self._total += time.perf_counter() - self._start
      self._laps += 1
      self._start = None

  def value(self) -> float:
    return self._total

  def laps(self) -> int:
    return self._laps

  def reset(self):
    self._total, self._start, self._laps = 0.0, None, 0
