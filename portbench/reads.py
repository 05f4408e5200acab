"""What the readers (``metrics/<name>.py``) read, one function per
quantity. Each takes the `harness.Run` of a run (a `--trace 1` run for a
per-layer metric) and returns a number, or None where the cell has
nothing to read: a reader never makes up a 0.

Sources: the profiled sub-window (`devtrace.py`: busy time, device ops,
device time by operator), the measured window's counts over its host-clock
seconds, and probes that time one layer's call alone, many calls to a
synchronize (`Run.time_calls`).
"""
from __future__ import annotations

import dataclasses

CONV_OPS = ("aten::convolution", "aten::convolution_backward")
GEMM_OPS = ("aten::addmm", "aten::mm")


def _profile(run):
  p = run.profile
  return p if p and p.get("window_s") and p.get("units") else None


def idle_share(run):
  """% of the timed window in which no device operation ran: the device
  busy time per unit (iteration or call) of the profiled sub-window, times
  the timed window's units, over its seconds. The profiler slows the host
  but not the card's work, so the profiled sub-window's own wall time
  would read the idle share of a slower host."""
  p = _profile(run)
  units = run.window.get("iterations", run.window.get("calls"))
  seconds = run.window.get("seconds")
  if p is None or not units or not seconds:
    return None
  return 100.0 * (1.0 - p["busy_s"] / p["units"] * units / seconds)


def _mfu(run, flops_key, units):
  flops = (run.model or {}).get(flops_key)
  seconds = run.window.get("seconds")
  if not flops or not units or not seconds:
    return None
  return 100.0 * flops * units / seconds / run.model["peak"]


def step_mfu_iterations(run):
  """% of the peak that the window's fused iterations' model FLOPs
  reach."""
  return _mfu(run, "flops_per_iteration", run.window.get("iterations"))


def train_step_device_ms(run):
  """ms of device time per train step: the union of the device spans of
  the profiled sub-window (`devtrace.reduce_trace`) over its train steps.
  The profiler slows the host but not the card's work."""
  p = _profile(run)
  per = (run.model or {}).get("train_steps_per_iteration")
  if p is None or not p["busy_s"] or not per:
    return None
  return p["busy_s"] * 1e3 / (p["units"] * per)


def host_train_steps_per_s(run):
  """Train steps completed in the timed window over its host-clock
  seconds."""
  return run.window.get("train_steps_per_s")


def step_mfu_train_steps(run):
  """% of the peak that a train step's model FLOPs reach over its device
  time (`train_step_device_ms`)."""
  ms = train_step_device_ms(run)
  flops = (run.model or {}).get("flops_per_train_step")
  if not ms or not flops:
    return None
  return 100.0 * flops / (ms / 1e3) / run.model["peak"]


def step_mfu_calls(run):
  """% of the peak that the window's act calls' forward FLOPs reach."""
  calls = run.window.get("calls")
  batch = run.traffic.get("batch")
  return _mfu(run, "flops_per_call", calls * batch if calls else None)


def _op_seconds(run, ops):
  p = _profile(run)
  if p is None:
    return None
  return sum(p["op_device_s"].get(op, 0.0) for op in ops)


def conv_roofline(run):
  """% of the device time of the convolutions (forward and backward) per
  iteration that their least time is."""
  least = (run.model or {}).get("conv_least_s_per_iteration")
  seconds = _op_seconds(run, CONV_OPS)
  if not least or not seconds:
    return None
  return 100.0 * least / (seconds / run.profile["units"])


def gemm_roofline(run):
  """% of the device time of the dense GEMMs per train step that their
  least time is (the collect's actor forward is in the time, not in the
  least time)."""
  least = (run.model or {}).get("gemm_least_s_per_train_step")
  per = (run.model or {}).get("train_steps_per_iteration")
  seconds = _op_seconds(run, GEMM_OPS)
  if not least or not per or not seconds:
    return None
  return 100.0 * least / (seconds / (run.profile["units"] * per))


def launches_per_iteration(run):
  p = _profile(run)
  if p is None or "iterations" not in run.window:
    return None
  return p["device_ops"] / p["units"]


def launches_per_train_step(run):
  p = _profile(run)
  per = (run.model or {}).get("train_steps_per_iteration")
  if p is None or "iterations" not in run.window or not per:
    return None
  return p["device_ops"] / (p["units"] * per)


def launches_per_call(run):
  p = _profile(run)
  if p is None or "calls" not in run.window:
    return None
  return p["device_ops"] / p["units"]


def collect_ms(run):
  """ms of one collect step of the loop alone (`initial_collect(state,
  1)`)."""
  loop, box = run.probes.get("loop"), run.probes.get("box")
  if loop is None:
    return None

  def call():
    box["state"] = loop.initial_collect(box["state"], 1)

  return run.time_calls(call)


def replay_sample_ms(run):
  """ms of one replay sample of the train step's windows alone."""
  loop, box = run.probes.get("loop"), run.probes.get("box")
  if loop is None:
    return None
  draws = run.probes["draws"]
  n = loop.agent.train_sequence_length

  def call():
    loop.replay.sample(box["state"].replay_state, draws,
                       loop.sample_batch_size, num_steps=n)

  return run.time_calls(call)


def train_step_ms(run):
  """ms of one train step of the agent alone, on batches sampled
  beforehand."""
  loop, box = run.probes.get("loop"), run.probes.get("box")
  if loop is None:
    return None
  draws = run.probes["draws"]
  n = loop.agent.train_sequence_length
  batches = [loop.replay.sample(box["state"].replay_state, draws,
                                loop.sample_batch_size, num_steps=n)[0]
             for _ in range(4)]
  count = [0]

  def call():
    state = box["state"]
    agent_state, _ = loop.agent.train(state.agent_state,
                                      batches[count[0] % len(batches)])
    box["state"] = dataclasses.replace(state, agent_state=agent_state)
    count[0] += 1

  return run.time_calls(call)


def program_ms(run):
  """ms of the loaded program's call alone, its inputs already on the
  card."""
  import os

  import numpy as np
  import torch

  exported = run.probes.get("exported")
  if exported is None:
    return None
  manifest = exported.manifest
  program = torch.export.load(os.path.join(
      exported.dir, manifest["programs"][exported.platform])).module()
  to = lambda xs: [torch.as_tensor(np.asarray(x)).to(exported.device)  # noqa: E731
                   for x in xs]
  obs = run.probes["pool"][0]
  flat_ts = to(exported.make_time_step([obs]))
  draws = to(exported.draw_inputs(len(obs), np.zeros((2,), np.uint32)))
  state = to(exported.initial_state(len(obs)))

  def call():
    with torch.no_grad():
      program(exported.params, draws, flat_ts, state)

  return run.time_calls(call)
