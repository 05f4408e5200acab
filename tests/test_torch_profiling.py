"""`agents_tpu_torch.utils.profiling`: the JAX test of `Timer` and
`annotate` (``tests/test_driver_metrics.py::
test_profiling_timer_and_annotate``) on the port, `annotate` as a
decorator too, and `trace` writing a chrome trace whose events hold the
annotated spans (on the CPU here; the card's trace is `chip_smoke.py`'s
`main` phase)."""
import json
import os
import time

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
