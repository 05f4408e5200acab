"""Profiling and timing utilities.

Port of ``agents_tpu/utils/profiling.py``: `trace(log_dir)` captures a
device trace, `annotate(name)` names a host span, and `Timer` is the
cumulative wall-clock timer of the reference's ``utils/timer.py``.

Spans are recorded only inside `record()`, which `trace` enters. Outside
it, entering or leaving an `annotate` span tests one module-level flag and
returns: no profiler call, no NVTX call, no allocation, so the port keeps
its spans on its hot paths. Inside it each entry of a span is kept in
memory with its name, its start and end on `time.perf_counter_ns`, its
parent span and its thread, and the request it serves: the entry number of
the enclosing request span (``annotate(name, request=True)``, such as the
fused loop's ``loop.iteration``). `count(name, n)` adds to a counter, and
`Recording.summary()` gives each span name's calls, total and self time
(the total less what its child spans cover), and the counters. Parents are
kept per thread, so one span object may be entered from several threads at
once.

While recording, a span is also a ``torch.profiler.record_function`` event
when a profiler is running, so it lands in the profiler's chrome trace
beside the operators and kernels it launched, and an NVTX range while CUDA
is initialized. `trace` runs `torch.profiler` over the CPU and, when a card
is present, CUDA activities, and writes that chrome trace (viewable in
Perfetto or ``chrome://tracing``) under `log_dir`.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"

# The recording in progress, or None: the one flag a span tests.
_recording: Optional["Recording"] = None


class Span:
  """One entry of a span: `end_ns` is None while it is open."""

  __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "request")

  def __init__(self, name, start_ns, parent, thread, request):
    self.name, self.start_ns, self.end_ns = name, start_ns, None
    self.parent, self.thread, self.request = parent, thread, request


class Recording:
  """The spans and counters recorded inside one `record()` block."""

  def __init__(self):
    self.spans: List[Span] = []
    self.counters: Dict[str, int] = {}
    self._requests: Dict[str, int] = {}
    self._lock = threading.Lock()
    self._local = threading.local()

  def _stack(self) -> list:
    """This thread's open entries: (span, annotate, profiler event, NVTX
    pushed)."""
    stack = getattr(self._local, "stack", None)
    if stack is None:
      stack = self._local.stack = []
    return stack

  def _open(self, owner: "annotate"):
    stack = self._stack()
    parent = stack[-1][0] if stack else None
    if owner.request:
      with self._lock:
        request = self._requests.get(owner.name, 0)
        self._requests[owner.name] = request + 1
    else:
      request = parent.request if parent is not None else None
    event = None
    if torch._C._autograd._profiler_enabled():
      event = record_function(owner.name)
      event.__enter__()
    nvtx = torch.cuda.is_initialized()
    if nvtx:
      torch.cuda.nvtx.range_push(owner.name)
    span = Span(owner.name, time.perf_counter_ns(), parent,
                threading.get_ident(), request)
    self.spans.append(span)
    stack.append((span, owner, event, nvtx))

  def _close(self, owner: "annotate", exc):
    end = time.perf_counter_ns()
    stack = self._stack()
    if not stack or stack[-1][1] is not owner:
      return    # entered before this recording began
    span, _, event, nvtx = stack.pop()
    span.end_ns = end
    if nvtx:
      torch.cuda.nvtx.range_pop()
    if event is not None:
      event.__exit__(*exc)

  def _add(self, name: str, n: int):
    with self._lock:
      self.counters[name] = self.counters.get(name, 0) + n

  def summary(self) -> dict:
    """{"spans": {name: {"calls", "total_ns", "self_ns"}}, "counters":
    {name: total}}, over the entries that closed."""
    spans = {}
    for span in self.spans:
      if span.end_ns is None:
        continue
      entry = spans.setdefault(span.name,
                               {"calls": 0, "total_ns": 0, "self_ns": 0})
      took = span.end_ns - span.start_ns
      entry["calls"] += 1
      entry["total_ns"] += took
      entry["self_ns"] += took
      # A parent is entered, so kept, before its children.
      if span.parent is not None and span.parent.end_ns is not None:
        spans[span.parent.name]["self_ns"] -= took
    return {"spans": spans, "counters": dict(self.counters)}


@contextlib.contextmanager
def record():
  """Record spans and counters inside the block; yields the `Recording`.
  Inside a recording already in progress it yields that one and leaves it
  running."""
  global _recording
  if _recording is not None:
    yield _recording
    return
  _recording = recording = Recording()
  try:
    yield recording
  finally:
    _recording = None


def count(name: str, n: int = 1):
  """Add `n` to counter `name` while recording; nothing otherwise."""
  if _recording is None:
    return
  _recording._add(name, n)


@contextlib.contextmanager
def trace(log_dir: str):
  """Capture a `torch.profiler` trace of the block into
  ``log_dir/trace.json``, recording spans (`record`) for its length.

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
  with profile(activities=activities) as prof, record():
    yield prof
  prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class annotate(contextlib.ContextDecorator):  # noqa: N801 (the JAX name)
  """A named host span, usable as a decorator or a context manager; see
  the module docstring for what it records, and when. `request` marks a
  span that stands for one request: the spans inside it carry its entry
  number."""

  def __init__(self, name: str, request: bool = False):
    self.name = name
    self.request = request

  def __enter__(self):
    if _recording is None:
      return self
    _recording._open(self)
    return self

  def __exit__(self, *exc):
    if _recording is None:
      return False
    _recording._close(self, exc)
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
