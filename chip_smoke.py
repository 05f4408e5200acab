#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
card, imports nothing of JAX or `agents_tpu`, and exits non-zero when
`torch.cuda.is_available()` is false. Each phase prints one JSON line;
any failed phase exits non-zero before the last line.

  1. device   torch/CUDA versions, the card's name and power limit.
  2. parity   5 fused iterations at B=64, MLP (100, 50) on "cpu" and on
              "cuda" from one set of numpy-made params and one replayed
              stream of draws (TF32 off): losses, params, target params,
              replay storage and metrics agree (floats rtol 1e-5 /
              atol 1e-6; ints and step types exactly).
  3. main     the bench operating point (B=4096 env rows, ring 512, sample
              256, MLP (100, 50), eps 0.1, gamma 0.99, tau 0.05 every 5,
              Adam 1e-3): init with 100 collect steps, warm-up, then 500
              timed iterations (5 windows of 100) under
              ``torch.cuda.set_sync_debug_mode("error")``, which fails on
              any host sync; tensors on the card, finite losses, exact
              replay count, legal step-type transitions. Prints
              ms/iteration and env-steps/s, and the device-busy share from
              a short profiled window.
  4. learn    the same run continued to 6000 iterations; the last-20
              AverageReturn must reach 195.
  5. eval     greedy `evaluate` over exactly 30 episodes.
  6. kernels  the port's hand-written kernels on this path (none: the JAX
              package has no Pallas kernel at HEAD).
  7. the last line: {"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import time

B_PARITY, B_MAIN = 64, 4096
MAIN = dict(capacity=512, sample_batch_size=256, fc=(100, 50))
TIMED_ITERATIONS, WARMUP_ITERATIONS, LEARN_ITERATIONS = 500, 50, 6000
TIMED_WINDOWS = 5
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                        "chip_smoke")
RTOL, ATOL = 1e-5, 1e-6


def emit(phase, **fields):
  print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase, message):
  emit(phase, ok=False, error=message)
  sys.exit(1)


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True)
  return out.stdout.strip().splitlines()[0]


def build_loop(device, batch_size, capacity, sample_batch_size, fc):
  """The example's loop (eps 0.1, gamma 0.99, tau 0.05 every 5, Adam 1e-3,
  seed 0) at this width."""
  from examples.dqn_cartpole_torch import Config
  from examples.dqn_cartpole_torch import build_loop as example_loop

  return example_loop(Config(
      env_batch_size=batch_size, replay_capacity=capacity,
      sample_batch_size=sample_batch_size, fc_layer_params=fc,
      device=device))


def numpy_q_params(rng, fc, obs_dim=4, num_actions=2):
  """A flax-shaped Q-network param tree drawn with numpy."""
  import numpy as np

  def dense(n_in, n_out, scale):
    return {"kernel": rng.uniform(-scale, scale, (n_in, n_out)).astype(
        np.float32), "bias": rng.uniform(-0.1, 0.1, (n_out,)).astype(
            np.float32)}

  encoder, width = {}, obs_dim
  for i, out in enumerate(fc):
    encoder[f"Dense_{i}"] = dense(width, out, math.sqrt(6.0 / width))
    width = out
  return {"params": {"EncoderModule_0": encoder,
                     "Dense_0": dense(width, num_actions, 0.03)}}


def max_diff(a, b):
  return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_parity():
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert, nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  fc = (100, 50)
  state_dict = convert.q_params_to_state_dict(
      numpy_q_params(np.random.RandomState(0), fc))
  runs = {}
  records = None
  for device in ("cpu", "cuda"):
    loop = build_loop(device, B_PARITY, capacity=64, sample_batch_size=64,
                      fc=fc)
    loop.agent.q_network.load_state_dict(state_dict)
    if device == "cpu":
      draws = RecordingDraws(Draws(0, "cpu"))
    else:
      draws = ReplayDraws(records, device)
    state = loop.init(draws=draws, initial_collect_steps=16)
    state, losses = loop.run(state, 5)
    if device == "cpu":
      records = draws.records
    runs[device] = (loop, state, losses)

  (cloop, cstate, closses), (gloop, gstate, glosses) = runs["cpu"], runs["cuda"]
  diffs, exact_mismatch = {}, []

  def compare(name, a, b):
    b = b.cpu()
    if a.dtype.is_floating_point:
      diffs[name] = max_diff(a, b)
      if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
        exact_mismatch.append(name)
    elif not torch.equal(a, b):
      exact_mismatch.append(name)

  compare("losses", closses, glosses)
  for tag, net in (("q", "q_network"), ("target_q", "target_q_network")):
    csd = getattr(cstate.agent_state, net).state_dict()
    gsd = getattr(gstate.agent_state, net).state_dict()
    for k in csd:
      compare(f"{tag}.{k}", csd[k], gsd[k])
  cleaves = nest_utils.flatten(cstate.replay_state.storage)
  gleaves = nest_utils.flatten(gstate.replay_state.storage)
  names = ["step_type", "observation", "action", "next_step_type", "reward",
           "discount"]
  for name, a, b in zip(names, cleaves, gleaves):
    compare(f"replay.{name}", a, b)
  cres, gres = cloop.results(cstate), gloop.results(gstate)
  for k in cres:
    compare(f"metric.{k}", cres[k], gres[k])
  if cstate.replay_state.count != gstate.replay_state.count:
    exact_mismatch.append("replay.count")
  worst = max(diffs, key=diffs.get)
  emit("parity", batch_size=B_PARITY, iterations=5, rtol=RTOL, atol=ATOL,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       loss_diff=diffs["losses"], replay_obs_diff=diffs["replay.observation"],
       mismatched=exact_mismatch, ok=not exact_mismatch)
  if exact_mismatch:
    fail("parity", f"card and CPU disagree on {exact_mismatch}")


def loop_tensors(state):
  """Every tensor a LoopState holds (optimizer step counters excepted:
  torch's non-capturable Adam keeps them on the host by design)."""
  import torch

  from agents_tpu_torch.utils import nest_utils

  out = [x for x in nest_utils.flatten(
      (state.driver_state, state.replay_state.storage, state.metric_states))
         if isinstance(x, torch.Tensor)]
  agent = state.agent_state
  out += list(agent.q_network.parameters())
  out += list(agent.target_q_network.parameters())
  for per_param in agent.optimizer.state.values():
    out += [v for k, v in per_param.items()
            if isinstance(v, torch.Tensor) and k != "step"]
  return out


def check_step_types(loop, state):
  """Legal transitions over the whole ring: post-LAST is FIRST, and each
  frame's next step type is the following frame's step type."""
  import torch

  from agents_tpu_torch.trajectories.time_step import StepType

  frames = loop.replay.gather_all(state.replay_state)
  size = loop.replay.size(state.replay_state)
  st = frames.step_type[:, :size]                             # [B, size]
  nst = frames.next_step_type[:, :size]
  bad = int(((st == StepType.LAST) != (nst == StepType.FIRST)).sum())
  bad += int((nst[:, :-1] != st[:, 1:]).sum())
  newest = (state.replay_state.count - 1) % loop.replay.capacity
  bad += int((state.replay_state.storage.next_step_type[newest]
              != state.driver_state.time_step.step_type).sum())
  return bad, int((st == StepType.LAST).sum())


def profile_window(loop, state, iterations):
  """Device-busy share and the top device ops over a short profiled window,
  read from the profiler's chrome trace (written under ``runs/``)."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    state, _ = loop.run(state, iterations)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  os.makedirs(RUNS_DIR, exist_ok=True)
  trace = os.path.join(RUNS_DIR, "profile_trace.json")
  prof.export_chrome_trace(trace)
  with open(trace) as f:
    events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
  # Device work only: kernels, copies and sets. Annotations on the device
  # timeline span work that is already counted; the union of the spans is
  # the busy time.
  spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("cat") in DEVICE_ACTIVITIES)
  busy_us, busy_end, by_name = 0.0, float("-inf"), {}
  for start, end, name in spans:
    busy_us += max(0.0, end - max(start, busy_end))
    busy_end = max(busy_end, end)
    total, count = by_name.get(name, (0.0, 0))
    by_name[name] = (total + end - start, count + 1)
  top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
  categories = {}
  for e in events:
    categories[e.get("cat")] = categories.get(e.get("cat"), 0) + 1
  return state, {
      "iterations": iterations,
      "wall_ms_per_iteration": wall_us / 1e3 / iterations,
      "device_ms_per_iteration": busy_us / 1e3 / iterations,
      "device_busy_share": busy_us / wall_us,
      "device_ops_per_iteration": len(spans) / iterations,
      "trace_events_per_iteration": {str(k): v / iterations
                                     for k, v in categories.items()},
      "top": [{"name": name[:80], "device_ms_per_iteration": us / 1e3 /
               iterations, "calls_per_iteration": c / iterations}
              for name, (us, c) in top]}


def phase_main_and_learn(card):
  import torch

  loop = build_loop("cuda", B_MAIN, **MAIN)
  t_init = time.perf_counter()
  state = loop.init(seed=0, initial_collect_steps=100)
  state, losses = loop.run(state, WARMUP_ITERATIONS)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t_init

  # Timed in windows, each ended by a synchronize outside the debug mode,
  # so the spread between windows shows beside the mean.
  window_ms, window = [], TIMED_ITERATIONS // TIMED_WINDOWS
  for _ in range(TIMED_WINDOWS):
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    state, losses = loop.run(state, window)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    window_ms.append((time.perf_counter() - t0) * 1e3 / window)
  dt = sum(window_ms) * window / 1e3

  iterations = WARMUP_ITERATIONS + TIMED_ITERATIONS
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  expected_count = 100 + iterations
  bad_transitions, lasts = check_step_types(loop, state)
  replay_count = state.replay_state.count
  ok = (not off_card and finite and bad_transitions == 0
        and replay_count == expected_count)
  state, prof = profile_window(loop, state, 50)
  iterations += 50
  emit("main", card=card, batch_size=B_MAIN, **{k: list(v) if isinstance(
      v, tuple) else v for k, v in MAIN.items()},
       timed_iterations=TIMED_ITERATIONS, sync_debug_mode="error",
       ms_per_iteration=dt * 1e3 / TIMED_ITERATIONS,
       window_ms_per_iteration=window_ms,
       env_steps_per_s=TIMED_ITERATIONS * B_MAIN / dt,
       init_and_warmup_s=init_s, tensors_off_card=off_card,
       losses_finite=finite, replay_count=replay_count,
       expected_replay_count=expected_count,
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts, profile=prof, ok=ok)
  if not ok:
    fail("main", "main-path checks failed")

  t0, learn_start = time.perf_counter(), iterations
  while iterations < LEARN_ITERATIONS:
    n = min(500, LEARN_ITERATIONS - iterations)
    state, losses = loop.run(state, n)
    iterations += n
  results = {k: float(v) for k, v in loop.results(state).items()}
  learn_s = time.perf_counter() - t0
  ok = results["AverageReturn"] >= 195.0 and bool(torch.isfinite(losses).all())
  emit("learn", card=card, iterations=iterations,
       last20_average_return=results["AverageReturn"], metrics=results,
       seconds=learn_s,
       ms_per_iteration=learn_s * 1e3 / (iterations - learn_start), ok=ok)
  if not ok:
    fail("learn", f"last-20 AverageReturn {results['AverageReturn']} < 195")
  return loop, state


def phase_eval(loop, state, card):
  import torch

  t0 = time.perf_counter()
  out = loop.evaluate(state, 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  torch.cuda.synchronize()
  ok = episodes == 30
  emit("eval", card=card, episodes=episodes,
       average_return=float(out["AverageReturn"]),
       average_episode_length=float(out["AverageEpisodeLength"]),
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("eval", f"counted {episodes} episodes, asked for 30")


def main():
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs a CUDA card", file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import agents_tpu_torch  # noqa: F401  (fails outside the repository)

  card = card_line()
  print(card, flush=True)
  emit("device", torch=torch.__version__, cuda=torch.version.cuda,
       name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
       nvidia_smi=card, host_cpus=os.cpu_count(),
       host_loadavg=os.getloadavg())
  phase_parity()
  loop, state = phase_main_and_learn(card)
  phase_eval(loop, state, card)
  emit("kernels", note="agents_tpu has no Pallas kernel at HEAD, so this "
       "path has no hand-written kernel to build or check")
  print(json.dumps({"kernels": []}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
