"""QT-Opt's operation and byte counts, and the device time of CEM's own
span.

Counts are analytic, from the configuration's shapes, 2 FLOPs per
multiply-add, as `flops.py` counts (its peaks and bandwidth are used).
The critic is `reference/qtopt.py`'s: a torso on the image, and a head
(the merge's Dense layers, the head's convolutions and Dense layers, the
logit) on each (image, action) pair.

`iteration_flops` is the model FLOPs of one fused iteration: the collect
step's CEM on the B rows (the torso once a row, the head on each of its
``iterations * N + 1`` candidates, the final answer's included); the
train step's CEM on the S next observations, counted alike; the online
forward and backward on the S transitions, the backward taken as twice
the forward less the first convolution's input gradient, which autograd
never computes; and the two delayed critics' forwards at the chosen
actions.

`conv_least_s_per_iteration` is the least time of every convolution
those launch, forward and backward: per convolution call its FLOPs over
the peak or its bytes over HBM bandwidth, the larger, each input (the
activations, the weight and bias) read once and the output written once
in float32. `cem_least_s_per_iteration` is the least time of the work
inside the two CEM calls of an iteration (``cem.optimize``): their
convolutions, max-pools (bytes alone) and Dense layers, counted the same
way; the elementwise work (ReLU, the merge's add, sampling, top-k,
refit) is left out, as a fused kernel would leave it.

`span_device_seconds` reads, from a profiled stretch of its own, the
device time of the operations launched inside ``cem.optimize``.
"""
from __future__ import annotations

import json
import os
import tempfile

from portbench import flops, lstm

SPANS = ("cem.optimize",)
F32 = 4


def _pools(pools) -> dict:
  return {layer: (kernel, stride) for layer, kernel, stride in pools}


def _out(size, kernel, stride, padding):
  return -(-size // stride) if padding == "SAME" else (
      (size - kernel) // stride + 1)


def layers(hp):
  """(torso, head): per part its layers in order, each ("conv", in size,
  in channels, out size, out channels, kernel), ("pool", in size,
  channels, out size) or ("dense", in width, out width)."""
  torso, head = [], []
  size, cin = hp["image_size"], 3
  parts = ((torso, hp["torso_conv_layer_params"], hp["torso_padding"],
            _pools(hp["torso_max_pools"])),
           (head, hp["head_conv_layer_params"],
            ["SAME"] * len(hp["head_conv_layer_params"]),
            _pools(hp["head_max_pools"])))
  for out, convs, paddings, pools in parts:
    if out is head:
      width = 8 + 2
      for units in hp["merge_fc_layer_params"]:
        head.append(("dense", width, units))
        width = units
    for i, ((filters, kernel, stride), padding) in enumerate(zip(convs,
                                                                 paddings)):
      new = _out(size, kernel, stride, padding)
      out.append(("conv", size, cin, new, filters, kernel))
      size, cin = new, filters
      if i in pools:
        new = _out(size, *pools[i], "VALID")
        out.append(("pool", size, cin, new))
        size = new
  width = size * size * cin
  for units in tuple(hp["head_fc_layer_params"]) + (1,):
    head.append(("dense", width, units))
    width = units
  return torso, head


def _flops(layer) -> int:
  if layer[0] == "conv":
    _, _, cin, out, cout, kernel = layer
    return 2 * out * out * cout * kernel * kernel * cin
  if layer[0] == "dense":
    return 2 * layer[1] * layer[2]
  return 0


def forward_flops(hp):
  """(torso FLOPs of one image, head FLOPs of one candidate)."""
  torso, head = layers(hp)
  return sum(map(_flops, torso)), sum(map(_flops, head))


def candidates_per_row(hp) -> int:
  return hp["cem_num_iterations"] * hp["cem_num_samples"] + 1


def iteration_flops(hp) -> int:
  torso, head = forward_flops(hp)
  rows, sample = hp["env_batch_size"], hp["sample_batch_size"]
  cem = torso + candidates_per_row(hp) * head
  first_conv = _flops(layers(hp)[0][0])
  forward = torso + head
  return ((rows + sample) * cem + sample * (3 * forward - first_conv)
          + 2 * sample * forward)


def _conv_seconds(layer, rows, peak, kind="forward") -> float:
  """One call of conv `layer` over `rows` images: "forward", "weight"
  (its weight and bias gradient) or "input" (its input gradient)."""
  _, size, cin, out, cout, kernel = layer
  x, y = size * size * cin, out * out * cout
  w = cout * cin * kernel * kernel
  nbytes = {"forward": rows * (x + y) + w + cout,
            "weight": rows * (x + y) + w + cout,
            "input": rows * (x + y) + w}[kind]
  return max(rows * _flops(layer) / peak,
             F32 * nbytes / flops.HBM_BYTES_PER_S)


def _pool_seconds(layer, rows) -> float:
  _, size, channels, out = layer
  return F32 * rows * channels * (size * size + out * out) \
      / flops.HBM_BYTES_PER_S


def _dense_seconds(layer, rows, peak) -> float:
  _, n_in, n_out = layer
  nbytes = rows * (n_in + n_out) + n_in * n_out + n_out
  return max(rows * _flops(layer) / peak,
             F32 * nbytes / flops.HBM_BYTES_PER_S)


def _head_calls(hp, rows):
  """Rows of each call of the head inside one CEM call over `rows`
  observations: N * rows a round, then the answer's rows."""
  return [hp["cem_num_samples"] * rows] * hp["cem_num_iterations"] + [rows]


def conv_least_s_per_iteration(hp, peak: float) -> float:
  torso, head = layers(hp)
  rows, sample = hp["env_batch_size"], hp["sample_batch_size"]
  convs = [(layer, part) for part, group in (("torso", torso),
                                             ("head", head))
           for layer in group if layer[0] == "conv"]
  total = 0.0
  for layer, part in convs:
    calls = [sample] * 3                      # online, two delayed critics
    for cem_rows in (rows, sample):
      calls += [cem_rows] if part == "torso" else _head_calls(hp, cem_rows)
    total += sum(_conv_seconds(layer, r, peak) for r in calls)
    total += _conv_seconds(layer, sample, peak, "weight")
    if layer is not torso[0]:
      total += _conv_seconds(layer, sample, peak, "input")
  return total


def cem_least_s_per_iteration(hp, peak: float) -> float:
  torso, head = layers(hp)
  total = 0.0
  for cem_rows in (hp["env_batch_size"], hp["sample_batch_size"]):
    for part, calls in ((torso, [cem_rows]),
                        (head, _head_calls(hp, cem_rows))):
      for layer in part:
        for r in calls:
          if layer[0] == "conv":
            total += _conv_seconds(layer, r, peak)
          elif layer[0] == "pool":
            total += _pool_seconds(layer, r)
          else:
            total += _dense_seconds(layer, r, peak)
  return total


def span_device_seconds(run, iterations: int = 2):
  """Device seconds per iteration of the operations launched inside
  ``cem.optimize``, from `iterations` iterations of the loop's own `run`
  in `profiling.trace`, once per run (kept on `run.probes`); None off the
  card, without the loop, or where the program opens no such span."""
  if "cem_device_s" in run.probes:
    return run.probes["cem_device_s"]
  from portbench import spans

  out = None
  profiling = spans._profiling()
  if run.on_card and "loop" in run.probes and profiling is not None:
    loop, box = run.probes["loop"], run.probes["box"]
    with tempfile.TemporaryDirectory(prefix="portbench_cem_") as log_dir:
      run.sync()
      with profiling.record() as rec, profiling.trace(log_dir):
        box["state"], _ = loop.run(box["state"], iterations)
        run.sync()
      with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = set(rec.summary()["spans"])
    if names & set(SPANS):
      by_span = lstm.device_seconds_by_span(events, names)
      out = sum(by_span.get(name, 0.0) for name in SPANS) / iterations
  run.probes["cem_device_s"] = out
  return out
