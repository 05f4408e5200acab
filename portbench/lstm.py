"""R2D2's operation and byte counts, and the device time of the LSTM's
own spans.

Counts are analytic, from the configuration's shapes, 2 FLOPs per
multiply-add, as `flops.py` counts (its peaks and bandwidth are used).

`r2d2_iteration_flops` is the model FLOPs of one fused iteration: the
collect forward on the B rows; the train step's online and target
forwards over every frame of the S windows (burn-in included), and the
online backward over the trained frames, taken as twice their forward.

`recurrence_least_seconds` is the least time of the work the LSTM's spans
(``lstm.unroll``, ``lstm.backward``) hold in one iteration: per forward
time step the recurrent product ``[rows, H] x [H, 4H]`` added to the
gates, reading the gates' inputs, the recurrent weight and the carry and
writing the new carry and output; per backward time step the product of
the gates' gradient and the recurrent weight; and once per backward the
recurrent weight's gradient over all its steps. The input products run
outside those spans (one product before the time loop) and are not
counted; nor is the elementwise gate arithmetic's (under 2% of the
products').

`span_device_seconds` reads, from a profiled stretch of its own, the
device time of the operations launched inside the LSTM's spans: the
benchmark's shared profiled stretch (`spans.py`) counts launches by span
but keeps no device time by span.
"""
from __future__ import annotations

import json
import os
import tempfile

from portbench import flops

SPANS = ("lstm.unroll", "lstm.backward")
F32 = 4


def _torso_flops(hp) -> int:
  size, cin, total = hp["pixels_size"], hp["pixels_frames"], 0
  for filters, kernel, stride in hp["conv_layer_params"]:
    size = (size - kernel) // stride + 1
    total += size * size * filters * kernel * kernel * cin * 2
    cin = filters
  width = size * size * cin
  for out in hp["fc_layer_params"]:
    total += width * out * 2
    width = out
  return total


def frame_forward_flops(hp) -> int:
  """FLOPs of one frame through R2D2's network: torso and fc, the LSTM's
  input and recurrent products, the two dueling streams."""
  cells, actions = hp["lstm_size"], hp["pixels_actions"]
  core_in = hp["fc_layer_params"][-1] + actions + 1
  total = _torso_flops(hp) + 2 * (core_in + cells) * 4 * cells
  for outputs in (1, actions):
    width = cells
    for units in tuple(hp["dueling_fc_layer_params"]) + (outputs,):
      total += 2 * width * units
      width = units
  return total


def r2d2_iteration_flops(hp) -> int:
  rows, sample = hp["env_batch_size"], hp["sample_batch_size"]
  length = hp["train_sequence_length"]
  trained = length - hp["burn_in"]
  frames = rows + 2 * sample * length + 2 * sample * trained
  return frame_forward_flops(hp) * frames


def _step_seconds(rows: int, cells: int, peak: float) -> float:
  """One time step's recurrent product with its reads and writes."""
  product = 2 * rows * cells * 4 * cells
  nbytes = F32 * (4 * cells * cells + rows * 4 * cells + 2 * rows * cells
                  + 3 * rows * cells)
  return max(product / peak, nbytes / flops.HBM_BYTES_PER_S)


def recurrence_least_seconds(hp, peak: float) -> float:
  """Least time of one iteration's work inside the LSTM's spans."""
  cells = hp["lstm_size"]
  rows, sample = hp["env_batch_size"], hp["sample_batch_size"]
  length = hp["train_sequence_length"]
  trained = length - hp["burn_in"]
  total = _step_seconds(rows, cells, peak)                 # collect
  total += 2 * length * _step_seconds(sample, cells, peak)  # online, target
  total += trained * _step_seconds(sample, cells, peak)    # backward steps
  weight_grad = 2 * trained * sample * 4 * cells * cells
  weight_bytes = F32 * (trained * sample * 5 * cells + 4 * cells * cells)
  total += max(weight_grad / peak, weight_bytes / flops.HBM_BYTES_PER_S)
  return total


def device_seconds_by_span(events, names) -> dict:
  """{innermost program span of the launch: seconds of device time} of a
  chrome trace's device operations (`spans.reduce` puts down launches the
  same way)."""
  from portbench import devtrace, spans

  by_tid = spans._intervals_by_thread(events, names)
  launches = {}
  for e in events:
    if e.get("ph") == "X" and e.get("cat") in spans.LAUNCH_CATEGORIES:
      correlation = (e.get("args") or {}).get("correlation")
      if correlation is not None:
        launches[correlation] = (float(e["ts"]), e.get("tid"))
  out = {}
  for e in events:
    if e.get("ph") != "X" or e.get("cat") not in devtrace.DEVICE_ACTIVITIES:
      continue
    launch = launches.get((e.get("args") or {}).get("correlation"))
    label = spans.OUTSIDE
    if launch is not None:
      ts, tid = launch
      label = spans._innermost(by_tid, ts, tid if tid in by_tid else None) \
          or spans.OUTSIDE
    out[label] = out.get(label, 0.0) + float(e["dur"]) / 1e6
  return out


def span_device_seconds(run, iterations: int = 2):
  """Device seconds per iteration of the operations launched inside the
  LSTM's spans, from `iterations` iterations of the loop's own `run` in
  `profiling.trace`, once per run (kept on `run.probes`); None off the
  card, without the loop, or where the program opens no such span."""
  if "lstm_device_s" in run.probes:
    return run.probes["lstm_device_s"]
  from portbench import spans

  out = None
  profiling = spans._profiling()
  if run.on_card and "loop" in run.probes and profiling is not None:
    loop, box = run.probes["loop"], run.probes["box"]
    with tempfile.TemporaryDirectory(prefix="portbench_lstm_") as log_dir:
      run.sync()
      with profiling.record() as rec, profiling.trace(log_dir):
        box["state"], _ = loop.run(box["state"], iterations)
        run.sync()
      with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = set(rec.summary()["spans"])
    if names & set(SPANS):
      by_span = device_seconds_by_span(events, names)
      out = sum(by_span.get(name, 0.0) for name in SPANS) / iterations
  run.probes["lstm_device_s"] = out
  return out
