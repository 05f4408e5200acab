"""The profiled sub-window of a `--trace 1` run (and of every run of a
cell with an end-to-end metric read from the trace), and its arithmetic.

`torch.profiler` traces the CPU and the card over a short window after
the timed one. The busy time is the union of the device spans (kernels,
copies and sets) of its chrome trace over the window's wall time, as
``chip_smoke.py:843-893`` (`profile_call`) reckons it; the device ops are
those spans, counted. The trace file goes to the run's temporary
directory and is deleted once read.

The idle gaps are labelled by what the host was doing at each gap's
middle: the benchmark's own span (a name under ``portbench.``) that
covers it, and the latest-started operator still running then, or
"between ops" where none is (Python between two launches).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
TOP = 10
LABELLED_GAPS = 4000


def device_time_by_op(prof) -> Dict[str, float]:
  """Seconds of device time the profiler attributes to each operator
  (its own launches and its children's), by operator name."""
  out = {}
  for evt in prof.key_averages():
    us = getattr(evt, "device_time_total", None)
    if us is None:
      us = getattr(evt, "cuda_time_total", 0.0)
    out[evt.key] = out.get(evt.key, 0.0) + float(us) / 1e6
  return out


def profile_window(fn: Callable[[], object], sync: Callable[[], None]
                   ) -> dict:
  """Run `fn` under `torch.profiler` (CPU and CUDA) and reduce its
  trace (`reduce_trace`); adds ``op_device_s`` (`device_time_by_op`)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  sync()
  with profile(activities=activities) as prof:
    t0 = time.perf_counter()
    fn()
    sync()
    wall = time.perf_counter() - t0
  by_op = device_time_by_op(prof)
  fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)["traceEvents"]
  finally:
    os.remove(path)
  out = reduce_trace(events, wall)
  out["op_device_s"] = by_op
  return out


def _covering(starts, intervals, t):
  """The latest-started interval of `intervals` (sorted by start) that
  covers time `t`, or None."""
  i = bisect.bisect_right(starts, t) - 1
  while i >= 0:
    start, end, name = intervals[i]
    if end >= t:
      return name
    i -= 1
  return None


def reduce_trace(events: List[dict], wall_s: float) -> dict:
  """busy_s, window_s, device_ops, the top device ops by time and the
  longest idle gaps by the host's activity, from chrome-trace events."""
  spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_ACTIVITIES)
  busy_us, merged, by_name = 0.0, [], {}
  for start, end, name in spans:
    if merged and start <= merged[-1][1]:
      busy_us += max(0.0, end - merged[-1][1])
      merged[-1][1] = max(merged[-1][1], end)
    else:
      busy_us += end - start
      merged.append([start, end])
    by_name[name] = by_name.get(name, 0.0) + end - start
  gaps = sorted(((b[0] - a[1], 0.5 * (a[1] + b[0]))
                 for a, b in zip(merged, merged[1:]) if b[0] > a[1]),
                reverse=True)[:LABELLED_GAPS]
  host = [e for e in events if e.get("ph") == "X"
          and e.get("cat") in ("cpu_op", "user_annotation")]
  ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in host if e.get("cat") == "cpu_op")
  own = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in host if str(e.get("name", "")).startswith(SPAN_PREFIX))
  op_starts, own_starts = [o[0] for o in ops], [o[0] for o in own]
  by_label = {}
  for length, middle in gaps:
    label = (f"{_covering(own_starts, own, middle) or 'outside spans'}: "
             f"{_covering(op_starts, ops, middle) or 'between ops'}")
    by_label[label] = by_label.get(label, 0.0) + length
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
  idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
  return {
      "busy_s": busy_us / 1e6,
      "window_s": wall_s,
      "device_ops": len(spans),
      "device_ops_top": [[name, us / 1e6] for name, us in top],
      "idle_gaps": [[label, us / 1e6] for label, us in idle],
  }
