"""The program's own spans and counters (``agents_tpu_torch/utils/
profiling.py``), read by the span readers (``metrics/*_span_ms.*``,
``metrics/loop_self_ms.*``, ``metrics/apply_launches.*``) in `--trace 1`
runs on the card.

Two stretches run after the timed window and the readers before them,
once per run, shared by all of a cell's span readers (kept on
`run.probes`), on the state the window left:

- the recorded stretch: the loop's own `run` (or the act calls) inside
  `profiling.record()` with no profiler, at full pace, ended by a
  synchronize, just after the same work with recording off (whose pace is
  printed beside it: the cost of recording). A span's total over the
  program's own count of its unit (``loop.iteration`` entries, the
  ``agent.train_steps`` counter, ``act.call`` entries) is its host-clock
  time per unit.
- the profiled stretch: the same inside `profiling.trace` (recording and
  `torch.profiler`, CPU and CUDA). Each device operation is put down,
  through its launch's correlation id, to the innermost program span the
  launching thread was in, and each idle gap between device operations to
  the innermost program span the host was in at its middle; the gaps are
  printed on standard error.

A program that opens no span (one older than them) records nothing: each
reader then returns None. So do runs off the card.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

from portbench import devtrace

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside spans"
# What each unit of a metric is counted by in a recording.
UNITS = {"iterations": ("span", "loop.iteration"),
         "train_steps": ("counter", "agent.train_steps"),
         "calls": ("span", "act.call")}


def _profiling():
  """The program's recorder, or None where it cannot record."""
  from agents_tpu_torch.utils import profiling
  return profiling if hasattr(profiling, "record") else None


def stretch_units(traffic: dict):
  """(recorded, profiled) iterations or calls of a cell's two stretches:
  the traffic file's own ``span_stretches`` where it gives them, else four
  times and two fifths of its profiled sub-window (``profile_iterations``
  or ``profile_calls``); None where it has neither."""
  if "span_stretches" in traffic:
    recorded, profiled = traffic["span_stretches"]
    return recorded, profiled
  profile = traffic.get("profile_iterations", traffic.get("profile_calls"))
  if not profile:
    return None
  return 4 * profile, max(1, 2 * profile // 5)


def _units(summary: dict, per: str):
  kind, name = UNITS[per]
  if kind == "counter":
    return summary["counters"].get(name)
  return summary["spans"].get(name, {}).get("calls")


def _loop_stretch(run, profiling, iterations: int, wrap):
  loop, box = run.probes["loop"], run.probes["box"]
  run.sync()
  with wrap() as rec:
    t0 = time.perf_counter_ns()
    box["state"], _ = loop.run(box["state"], iterations)
    run.sync()
    wall_ns = time.perf_counter_ns() - t0
  return rec, wall_ns


def _act_stretch(run, profiling, calls: int, wrap):
  exported, pool = run.probes["exported"], run.probes["pool"]
  exported.span_hook = profiling.annotate
  try:
    run.sync()
    with wrap() as rec:
      t0 = time.perf_counter_ns()
      for i in range(calls):
        exported.action([pool[i % len(pool)]])
      run.sync()
      wall_ns = time.perf_counter_ns() - t0
  finally:
    exported.span_hook = None
  return rec, wall_ns


def plain_stretch(run, units: int) -> int:
  """ns of `units` iterations or calls with recording off, just before the
  recorded stretch: the host's pace at that moment, which the recorded
  stretch's is compared with (the host's pace wanders between the timed
  window and the stretches)."""
  stretch = _act_stretch if "exported" in run.probes else _loop_stretch
  return stretch(run, _profiling(), units, contextlib.nullcontext)[1]


def record_stretch(run, units: int) -> dict:
  """The recorded stretch of `units` iterations or calls: the recording's
  summary and its wall time, or None where the program records nothing."""
  profiling = _profiling()
  if profiling is None:
    return None
  stretch = _act_stretch if "exported" in run.probes else _loop_stretch
  rec, wall_ns = stretch(run, profiling, units, profiling.record)
  summary = rec.summary()
  if not summary["spans"]:
    return None
  return {"summary": summary, "wall_ns": wall_ns, "units": units}


def profile_stretch(run, units: int) -> dict:
  """The profiled stretch of `units` iterations or calls: the recording's
  summary and `reduce` of the chrome trace, or None where the program
  records nothing."""
  profiling = _profiling()
  if profiling is None:
    return None
  stretch = _act_stretch if "exported" in run.probes else _loop_stretch
  with tempfile.TemporaryDirectory(prefix="portbench_spans_") as log_dir:
    @contextlib.contextmanager
    def traced():
      with profiling.record() as rec, profiling.trace(log_dir):
        yield rec

    rec, _ = stretch(run, profiling, units, traced)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
      events = json.load(f)["traceEvents"]
  summary = rec.summary()
  if not summary["spans"]:
    return None
  requests = {s.name for s in rec.spans if s.parent is None}
  return {"summary": summary,
          **reduce(events, set(summary["spans"]), requests)}


def _intervals_by_thread(events, names):
  """{tid: (starts, [(start, end, name)] sorted by start)} of the
  program's spans in the chrome trace."""
  by_tid = {}
  for e in events:
    if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e.get("name") in names):
      start = float(e["ts"])
      by_tid.setdefault(e.get("tid"), []).append(
          (start, start + float(e["dur"]), e["name"]))
  out = {}
  for tid, spans in by_tid.items():
    spans.sort()
    out[tid] = ([s[0] for s in spans], spans)
  return out


def _innermost(by_tid, t, tid=None):
  """The innermost program span covering time `t` (on thread `tid`, or on
  any), or None."""
  found = None
  for key, (starts, spans) in by_tid.items():
    if tid is not None and key != tid:
      continue
    name = devtrace._covering(starts, spans, t)
    if name is not None:
      found = name
  return found


def reduce(events: list, names: set, requests: set) -> dict:
  """From a chrome trace: ``launched`` (device operations by the innermost
  program span their launch lay in), ``idle`` (seconds of the gaps
  between device operations by the innermost program span the host was in
  at each gap's middle) and ``idle_below_request`` (the share of that idle
  time in a program span other than a request span `requests`)."""
  by_tid = _intervals_by_thread(events, names)
  launches = {}
  for e in events:
    if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
      correlation = (e.get("args") or {}).get("correlation")
      if correlation is not None:
        launches[correlation] = (float(e["ts"]), e.get("tid"))
  device, launched = [], {}
  for e in events:
    if e.get("ph") != "X" or e.get("cat") not in devtrace.DEVICE_ACTIVITIES:
      continue
    start = float(e["ts"])
    device.append((start, start + float(e["dur"])))
    launch = launches.get((e.get("args") or {}).get("correlation"))
    label = OUTSIDE
    if launch is not None:
      ts, tid = launch
      label = _innermost(by_tid, ts, tid if tid in by_tid else None) \
          or OUTSIDE
    launched[label] = launched.get(label, 0) + 1
  device.sort()
  merged = []
  for start, end in device:
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  idle = {}
  for a, b in zip(merged, merged[1:]):
    if b[0] > a[1]:
      label = _innermost(by_tid, 0.5 * (a[1] + b[0])) or OUTSIDE
      idle[label] = idle.get(label, 0.0) + (b[0] - a[1]) / 1e6
  total = sum(idle.values())
  below = sum(s for label, s in idle.items()
              if label not in requests and label != OUTSIDE)
  return {"launched": launched, "idle": idle,
          "idle_below_request": below / total if total else None}


def _print(run, stretch: str, units: int, summary: dict, **more):
  """One JSON line on standard error: the stretch's spans per unit (total
  and self ms, calls), its counters, and `more`."""
  spans = {name: [s["total_ns"] / 1e6 / units, s["self_ns"] / 1e6 / units,
                  s["calls"]] for name, s in summary["spans"].items()}
  timed = run.window.get("iterations", run.window.get("calls"))
  line = {"units": units, "spans_ms_per_unit": spans,
          "counters": summary["counters"], **more,
          "timed_ms_per_unit": run.window["seconds"] * 1e3 / timed
          if timed else None}
  print(f"portbench: {stretch} stretch {json.dumps(line)}", file=sys.stderr)


def stretches(run):
  """{"recorded": ..., "profiled": ...} of this run, made once; None off
  the card, without the loop or the export to drive, or where the
  program records nothing."""
  if "spans" in run.probes:
    return run.probes["spans"]
  out = None
  units = stretch_units(run.traffic)
  drivable = "loop" in run.probes or "exported" in run.probes
  if run.on_card and units and drivable and _profiling() is not None:
    plain_ns = plain_stretch(run, units[0])
    recorded = record_stretch(run, units[0])
    if recorded is not None:
      _print(run, "recorded", units[0], recorded["summary"],
             wall_ms_per_unit=recorded["wall_ns"] / 1e6 / units[0],
             plain_ms_per_unit=plain_ns / 1e6 / units[0])
      profiled = profile_stretch(run, units[1])
      if profiled is not None:
        _print(run, "profiled", units[1], profiled["summary"],
               idle_s=profiled["idle"], launched=profiled["launched"],
               idle_below_request=profiled["idle_below_request"])
      out = {"recorded": recorded, "profiled": profiled}
  run.probes["spans"] = out
  return out


def per_unit_ms(summary: dict, span: str, per: str, field="total_ns"):
  """ms of `span`'s `field` per unit `per` ("iterations", "train_steps"
  or "calls"), or None where the recording lacks either."""
  units = _units(summary, per)
  entry = summary["spans"].get(span)
  if not units or entry is None:
    return None
  return entry[field] / 1e6 / units


def span_ms(run, span: str, per: str):
  """Host-clock ms of `span` per unit, from the recorded stretch."""
  got = stretches(run)
  return None if got is None else per_unit_ms(got["recorded"]["summary"],
                                              span, per)


def self_ms(run, span: str, per: str):
  """Host-clock ms of `span`'s self time per unit, from the recorded
  stretch."""
  got = stretches(run)
  return None if got is None else per_unit_ms(got["recorded"]["summary"],
                                              span, per, "self_ns")


def launches_per_unit(run, span: str, per: str):
  """Device operations launched inside `span` per unit, from the profiled
  stretch."""
  got = stretches(run)
  prof = got and got["profiled"]
  if not prof:
    return None
  units = _units(prof["summary"], per)
  launched = prof["launched"].get(span)
  return launched / units if units and launched is not None else None
