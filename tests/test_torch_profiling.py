"""`agents_tpu_torch.utils.profiling`: the JAX test of `Timer` and
`annotate` (``tests/test_driver_metrics.py::
test_profiling_timer_and_annotate``) on the port, `annotate` as a
decorator too, and `trace` writing a chrome trace whose events hold the
annotated spans (on the CPU here; the card's trace is `chip_smoke.py`'s
`main` phase). Then the recorder: a span outside `record()` touches no
profiler, NVTX or allocator; inside it, nesting, self time, counters,
request ids and per-thread parents; under `trace`, spans around their
operators. The program's own spans are `test_torch_spans.py`'s."""
import json
import os
import sys
import threading
import time
import tracemalloc

import torch

from agents_tpu.utils import profiling as jax_profiling
from agents_tpu_torch.utils import profiling


def _timer_case(module):
  t = module.Timer()
  with t:
    time.sleep(0.01)
  t.start()
  time.sleep(0.01)
  t.stop()
  t.stop()  # a stop without a start adds nothing
  laps, value = t.laps(), t.value()
  t.reset()
  return laps, value, t.laps(), t.value()


def test_timer_matches_jax():
  ours, theirs = _timer_case(profiling), _timer_case(jax_profiling)
  assert ours[0] == theirs[0] == 2
  assert 0.015 < ours[1] < 1.0 and 0.015 < theirs[1] < 1.0
  assert ours[2:] == theirs[2:] == (0, 0.0)


def test_annotate_is_a_context_manager_and_a_decorator():
  with profiling.annotate("test-span") as span:
    assert span.name == "test-span"

  @profiling.annotate("decorated")
  def f(n):
    return f(n - 1) + 1 if n else 0   # re-enters the same annotation

  assert f(3) == 3


def test_trace_writes_the_annotated_spans(tmp_path):
  @profiling.annotate("outer-span")
  def work():
    with profiling.annotate("inner-span"):
      return torch.ones(64, 64) @ torch.ones(64, 64)

  with profiling.trace(str(tmp_path)) as prof:
    out = work()
  assert float(out[0, 0]) == 64.0
  path = os.path.join(str(tmp_path), profiling.TRACE_FILE)
  with open(path) as f:
    names = {e.get("name") for e in json.load(f)["traceEvents"]}
  assert {"outer-span", "inner-span"} <= names
  assert any(e.key == "inner-span" for e in prof.key_averages())


class _Plain:
  """A context manager that does nothing: the floor of a `with`."""

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


def _peak_bytes(manager, entries=10_000):
  """Bytes live at the peak of `entries` entries of `manager`, over those
  live before them."""
  items = list(range(entries))
  tracemalloc.start()
  try:
    for _ in items:
      with manager:
        pass
    before, _ = tracemalloc.get_traced_memory()
    tracemalloc.reset_peak()
    for _ in items:
      with manager:
        pass
    _, peak = tracemalloc.get_traced_memory()
  finally:
    tracemalloc.stop()
  return peak - before


def test_a_span_outside_a_recording_calls_no_profiler_nor_nvtx(monkeypatch):
  calls = []
  monkeypatch.setattr(profiling, "record_function",
                      lambda name: calls.append(("record_function", name)))
  monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
  monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                      lambda name: calls.append(("push", name)))
  monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                      lambda: calls.append(("pop",)))
  span = profiling.annotate("off-span")

  @profiling.annotate("off-decorated")
  def f():
    with span:
      profiling.count("off-counter")
    return 1

  assert f() == 1
  assert calls == []
  # No allocation beyond what any `with` statement makes.
  assert _peak_bytes(span) <= _peak_bytes(_Plain())
  with profiling.record() as rec:
    with span:
      pass
  assert [c[0] for c in calls] == ["push", "pop"]   # no profiler running
  assert rec.summary()["spans"]["off-span"]["calls"] == 1


def test_recording_nests_spans_with_self_time_counters_and_requests():
  outer = profiling.annotate("req", request=True)
  inner = profiling.annotate("inner")
  other = profiling.annotate("other")
  before = profiling.annotate("before")
  with before:      # entered before the recording: left out of it
    with profiling.record() as rec:
      for _ in range(3):
        with outer:
          with inner:
            time.sleep(0.002)
          with other:
            with inner:
              time.sleep(0.001)
          profiling.count("rows", 4)
      profiling.count("steps")
      with profiling.record() as nested:   # the recording in progress
        assert nested is rec
  profiling.count("rows", 100)             # after it: not counted
  out = rec.summary()
  assert set(out["spans"]) == {"req", "inner", "other"}
  assert out["counters"] == {"rows": 12, "steps": 1}
  spans = out["spans"]
  assert spans["req"]["calls"] == 3 and spans["inner"]["calls"] == 6
  assert spans["other"]["calls"] == 3
  for name in ("req", "other"):
    assert 0 <= spans[name]["self_ns"] < spans[name]["total_ns"]
  assert spans["inner"]["self_ns"] == spans["inner"]["total_ns"]
  assert spans["inner"]["total_ns"] >= 9e6
  took = lambda span: span.end_ns - span.start_ns  # noqa: E731
  for name in ("req", "other"):
    children = sum(took(s) for s in rec.spans if s.parent is not None
                   and s.parent.name == name)
    assert spans[name]["self_ns"] == spans[name]["total_ns"] - children
  by_request = {}
  for span in rec.spans:
    by_request.setdefault(span.request, []).append(span.name)
  assert by_request == {i: ["req", "inner", "other", "inner"]
                        for i in range(3)}
  for span in rec.spans:
    assert span.end_ns >= span.start_ns
    if span.name == "req":
      assert span.parent is None
    else:
      assert span.parent.name in ("req", "other")
      assert span.parent.start_ns <= span.start_ns
      assert span.end_ns <= span.parent.end_ns


def test_parents_are_kept_per_thread_for_one_shared_span():
  """More threads than cores enter one module-level pair of spans at once,
  with a short switch interval: every child's parent is its own thread's
  entry, and no entry or count is lost."""
  parent = profiling.annotate("shared-parent", request=True)
  child = profiling.annotate("shared-child")
  threads_n, entries = 2 * (os.cpu_count() or 2) + 1, 200
  switch = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    with profiling.record() as rec:
      def work():
        for _ in range(entries):
          with parent:
            with child:
              profiling.count("entries")
      threads = [threading.Thread(target=work) for _ in range(threads_n)]
      for t in threads:
        t.start()
      for t in threads:
        t.join(timeout=120)
      assert not any(t.is_alive() for t in threads)
  finally:
    sys.setswitchinterval(switch)
  out = rec.summary()
  total = threads_n * entries
  assert out["counters"] == {"entries": total}
  assert out["spans"]["shared-parent"]["calls"] == total
  assert out["spans"]["shared-child"]["calls"] == total
  children = [s for s in rec.spans if s.name == "shared-child"]
  assert all(s.parent.name == "shared-parent"
             and s.parent.thread == s.thread
             and s.parent.request == s.request for s in children)
  assert sorted(s.request for s in rec.spans
                if s.name == "shared-parent") == list(range(total))


def test_trace_spans_enclose_their_operators(tmp_path):
  """Under `trace`, a recorded span is a `record_function` event of the
  chrome trace, on the profiler's clock, around the operators it ran."""
  span = profiling.annotate("program.matmul")
  a = torch.ones(64, 64)
  with profiling.trace(str(tmp_path)):
    for _ in range(3):
      with span:
        a @ a
  with open(os.path.join(str(tmp_path), profiling.TRACE_FILE)) as f:
    events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
  spans = [e for e in events if e["name"] == "program.matmul"]
  ops = [e for e in events if e.get("cat") == "cpu_op"
         and e["name"] in ("aten::mm", "aten::matmul")]
  assert len(spans) == 3 and ops
  for op in ops:
    assert any(s["ts"] <= op["ts"] and op["ts"] + op["dur"]
               <= s["ts"] + s["dur"] and s["tid"] == op["tid"]
               for s in spans)
