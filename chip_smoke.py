#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
card, imports nothing of JAX or `agents_tpu`, and exits non-zero when
`torch.cuda.is_available()` is false. Each phase prints one JSON line;
any failed phase exits non-zero before the last line.

  1. device       torch/CUDA versions, the card's name and power limit.
  2. parity       5 fused iterations at B=64, MLP (100, 50) on "cpu" and on
                  "cuda" from one set of numpy-made params and one replayed
                  stream of draws (TF32 off): losses, params, target params,
                  replay storage and metrics agree (floats rtol 1e-5 /
                  atol 1e-6; ints and step types exactly).
  3. main         the CartPole bench operating point (B=4096 env rows, ring
                  512, sample 256, MLP (100, 50), eps 0.1, gamma 0.99, tau
                  0.05 every 5, Adam 1e-3): init with 100 collect steps,
                  warm-up, then 500 timed iterations (5 windows of 100)
                  under ``torch.cuda.set_sync_debug_mode("error")``, which
                  fails on any host sync; tensors on the card, finite
                  losses, exact replay count, legal step-type transitions.
                  Prints ms/iteration and env-steps/s, and the device-busy
                  share from a short profiled window.
  4. learn        the same run continued to 6000 iterations; the last-20
                  AverageReturn must reach 195.
  5. eval         greedy `evaluate` over exactly 30 episodes.
  6. conv_parity  (a) `examples/dqn_pixels_torch.py`'s loop on
                  SyntheticPixels 20x20x4, mnih15 torso, fp32 (TF32 off,
                  deterministic cuDNN), B=8, ring 64, sample 16: 3 fused
                  iterations on "cpu" and "cuda" from numpy-made params and
                  one replayed draw stream agree (floats rtol 1e-4 / atol
                  1e-5; uint8 frames, actions and step types exactly).
                  (b) the bfloat16 bench network on 32 frames of 84x84x4:
                  Q values within atol 1e-2, greedy actions equal wherever
                  the top-two gap exceeds 1e-2.
  7. conv_main    the pixel bench point (``bench.py:conv_bench``: B=128,
                  sample 256, ring 2048 of uint8 84x84x4 frames, mnih15 +
                  fc 512 in bfloat16): 64 collect steps, 20 warm-up and 200
                  timed iterations (5 windows) under the sync debug mode;
                  the same checks as phase 3 plus the observation ring's
                  dtype and bytes. Prints ms/iteration, env-steps/s,
                  train-frames/s, a 20-iteration profile, and the analytic
                  model GFLOP per iteration with the TFLOP/s it gives.
  8. conv_learn   the example's ``--env=catch`` config: up to 2,400
                  iterations to a last-100 AverageReturn above 0.3, then
                  greedy `evaluate` over exactly 30 episodes.
  9. c51          C51 (51 atoms on [-10, 10]) at the pixel bench point:
                  100 iterations under the sync debug mode, finite losses.
 10. sac_parity   `examples/sac_pendulum_torch.py`'s loop at the SAC width
                  ((256, 256) actor and critics) on the device Pendulum,
                  B=8, ring 64, sample 32, 2 train steps per iteration:
                  16 collect steps then 3 fused iterations on "cpu" and
                  "cuda" from numpy-made params and one replayed stream of
                  draws (TF32 off): losses, the five networks, log alpha,
                  the three Adams' moments, replay storage and metrics
                  agree (floats rtol 1e-5 / atol 1e-5; step types exactly).
 11. sac_main     the SAC bench point (``bench.py:sac_live_probe``'s agent
                  and replay on the device Pendulum: B=32, ring 4096,
                  sample 256, (256, 256), Adam 3e-4 x3, tau 0.005, gamma
                  0.99, reward scale 0.1, UTD 1.0 = 32 train steps per
                  iteration, 64 collect steps): 5 warm-up and 50 timed
                  iterations (5 windows) under the sync debug mode; exact
                  replay count, finite losses and log alpha, legal step
                  types, tensors on the card. Prints ms/iteration,
                  env-steps/s, train-steps/s, a 5-iteration profile with
                  operator records per train step, and the analytic GFLOP
                  per train step.
 12. sac_learn    the example's ``--preset=live`` config (B=8, ring 8192,
                  sample 256, 4 train steps, (64, 64)): up to 8,000
                  iterations, checked every 250, to a last-20 AverageReturn
                  of -250 or more, then greedy `evaluate` over exactly 30
                  episodes.
 13. ppo_parity   the PPO learner, card against CPU on the CPU's rollouts
                  (TF32 off): `examples/ppo_cartpole_torch.py`'s CartPole
                  loop (B=32, T=128, 10 epochs x 8 minibatches, (64, 64))
                  for 2 iterations, and its schulman17 preset cut to
                  T=257 and 4 minibatches for 1, from numpy-made trees.
                  On each CPU rollout the card's policy outputs, then its
                  train step on a copy with the CPU's permutations: losses,
                  networks, Adam moments, normalizers, beta and learning
                  rate agree, each tensor to max|card - cpu| <= 1e-5 +
                  1e-4 * max|cpu| (the Adam moments 1e-5 + 1e-3 *
                  max|cpu|).
 14. ppo_main     the PPO CartPole point (`examples/ppo_cartpole.py`'s
                  config): 2 warm-up and 5 timed windows of 2 iterations
                  under the sync debug mode (median ms/iteration,
                  env-steps/s = B*T / that, minibatch steps/s); one
                  iteration split into collect, GAE and train; profiles of
                  2 iterations, of one `train` (operator records and
                  device ops per minibatch step) and of GAE alone; legal
                  step types, tensors on the card, finite losses.
 15. ppo_learn    the same loop continued, checked every 10 iterations, to
                  a last-20 AverageReturn of 195 within 150 iterations
                  (`PPO_CARTPOLE_LIVE`, ``return_windows.py:98``), then
                  greedy eval over exactly 30 episodes on 10 fresh rows.
 16. ppo_schulman17  the example's --preset=schulman17_pendulum (B=1,
                  T=2049, 10 x 32 minibatches of 64, tanh, std 0.35, Adam
                  eps 1e-5 decayed linearly, clipping 0.5): 1 warm-up and 3
                  timed iterations under the sync debug mode, the split of
                  one more into the 2,049-step collect, GAE and the 320
                  minibatch steps; finite losses, the decayed learning
                  rate.
 17. reinforce    REINFORCE with a (64, 64) value baseline on CartPole,
                  B=32, T=128: 1 warm-up and 5 timed iterations under the
                  sync debug mode, finite losses.
 18. kernels      the port's hand-written kernels on these paths (none: the
                  JAX package has no Pallas kernel at HEAD).
 19. the last line: {"ok": true, "device": {...}}.
"""
import dataclasses
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
MNIH15 = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
CONV_PARITY = dict(pixels_size=20, env_batch_size=8, replay_capacity=64,
                   sample_batch_size=16, dtype="float32")
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
BF16_ATOL = 1e-2
CONV_INITIAL, CONV_WARMUP, CONV_TIMED, CONV_PROFILED = 64, 20, 200, 20
CATCH_ITERATIONS, CATCH_CHUNK, CATCH_GATE = 2400, 400, 0.3
C51_WARMUP, C51_TIMED = 10, 100
SAC_PARITY = dict(env_batch_size=8, replay_capacity=64, sample_batch_size=32,
                  train_steps_per_iteration=2)
SAC_RTOL = SAC_ATOL = 1e-5
SAC_WARMUP, SAC_TIMED, SAC_PROFILED = 5, 50, 5
SAC_LEARN_ITERATIONS, SAC_LEARN_CHUNK, SAC_LEARN_GATE = 8000, 250, -250.0
PPO_PARITY_ITERATIONS = 2
PPO_PARITY_SCHULMAN17 = dict(rollout_length=257, num_minibatches=4)
PPO_RTOL, PPO_ATOL, PPO_MOMENT_RTOL = 1e-4, 1e-5, 1e-3
PPO_WARMUP, PPO_TIMED_WINDOWS, PPO_WINDOW, PPO_PROFILED = 2, 5, 2, 2
PPO_LEARN_ITERATIONS, PPO_LEARN_CHUNK, PPO_LEARN_GATE = 150, 10, 195.0
SCHULMAN17_TIMED = 3
REINFORCE_TIMED = 5


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


def numpy_q_params(rng, fc, obs_dim=4, num_actions=2, convs=(), image=None):
  """A flax-shaped Q-network param tree drawn with numpy; with `convs`, the
  encoder's leaf is an `image` (H, W, C) and Conv_i kernels are HWIO."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, shape[-1:]).astype(np.float32)}

  encoder, width = {}, obs_dim
  if convs:
    h, w, c = image
    for i, (filters, kernel, stride) in enumerate(convs):
      fan_in = kernel * kernel * c
      encoder[f"Conv_{i}"] = layer((kernel, kernel, c, filters),
                                   math.sqrt(6.0 / fan_in))
      h, w, c = -(-h // stride), -(-w // stride), filters
    width = h * w * c
  for i, out in enumerate(fc):
    encoder[f"Dense_{i}"] = layer((width, out), math.sqrt(6.0 / width))
    width = out
  return {"params": {"EncoderModule_0": encoder,
                     "Dense_0": layer((width, num_actions), 0.03)}}


def max_diff(a, b):
  return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def run_on_both(build, load, initial_collect_steps, iterations):
  """`build(device)`'s loop on "cpu" then "cuda", its networks set by
  `load(loop)`, the card replaying the CPU's stream of draws (an agent
  state that draws, as SAC's does, takes the same stream). Returns
  {device: (loop, state, losses)}."""
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  runs, records = {}, None
  for device in ("cpu", "cuda"):
    loop = build(device)
    load(loop)
    if device == "cpu":
      draws = RecordingDraws(Draws(0, "cpu"))
    else:
      draws = ReplayDraws(records, device)
    state = loop.init(draws=draws, initial_collect_steps=initial_collect_steps)
    if hasattr(state.agent_state, "draws"):
      state = dataclasses.replace(state, agent_state=dataclasses.replace(
          state.agent_state, draws=draws))
    state, losses = loop.run(state, iterations)
    if device == "cpu":
      records = draws.records
    runs[device] = (loop, state, losses)
  return runs


def dqn_tensors(agent_state):
  """The online and target Q networks' tensors by name."""
  return {f"{tag}.{k}": v
          for tag, net in (("q", "q_network"), ("target_q", "target_q_network"))
          for k, v in getattr(agent_state, net).state_dict().items()}


def sac_tensors(agent_state):
  """The five SAC networks' tensors, log alpha, the three Adams' moments
  and step counts, and the train step, by name."""
  import torch

  out = {f"{net}.{k}": v
         for net in ("actor_network", "critic1_network", "critic2_network",
                     "target_critic1_network", "target_critic2_network")
         for k, v in getattr(agent_state, net).state_dict().items()}
  out["log_alpha"] = agent_state.log_alpha.detach()
  for name in ("actor", "critic", "alpha"):
    optimizer = getattr(agent_state, f"{name}_optimizer")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
      for k, v in optimizer.state[p].items():
        out[f"{name}_adam.{i}.{k}"] = v
  out["train_step"] = torch.tensor(agent_state.train_step)
  return out


def compare_runs(runs, rtol, atol, agent_tensors=dqn_tensors):
  """Largest float difference by name, and the names that disagree (floats
  beyond rtol/atol, anything else at all)."""
  import torch

  from agents_tpu_torch.utils import nest_utils

  (cloop, cstate, closses), (gloop, gstate, glosses) = runs["cpu"], runs["cuda"]
  diffs, mismatched = {}, []

  def compare(name, a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
      diffs[name] = max_diff(a, b)
      if not torch.allclose(a, b, rtol=rtol, atol=atol):
        mismatched.append(name)
    elif not torch.equal(a, b):
      mismatched.append(name)

  compare("losses", closses, glosses)
  ctensors = agent_tensors(cstate.agent_state)
  gtensors = agent_tensors(gstate.agent_state)
  if set(ctensors) != set(gtensors):
    mismatched.append("agent_state.names")
  for k in ctensors:
    compare(k, ctensors[k], gtensors[k])
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
    mismatched.append("replay.count")
  return diffs, mismatched


def phase_parity():
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  fc = (100, 50)
  state_dict = convert.q_params_to_state_dict(
      numpy_q_params(np.random.RandomState(0), fc))
  runs = run_on_both(
      lambda device: build_loop(device, B_PARITY, capacity=64,
                                sample_batch_size=64, fc=fc),
      lambda loop: loop.agent.q_network.load_state_dict(state_dict),
      initial_collect_steps=16, iterations=5)
  diffs, exact_mismatch = compare_runs(runs, RTOL, ATOL)
  worst = max(diffs, key=diffs.get)
  emit("parity", batch_size=B_PARITY, iterations=5, rtol=RTOL, atol=ATOL,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       loss_diff=diffs["losses"], replay_obs_diff=diffs["replay.observation"],
       mismatched=exact_mismatch, ok=not exact_mismatch)
  if exact_mismatch:
    fail("parity", f"card and CPU disagree on {exact_mismatch}")


def loop_tensors(state):
  """Every tensor a loop state holds: the driver, replay (if any) and
  metric states, and each network, tensor, tensor nest and optimizer of
  the agent state (optimizer step counters excepted: torch's
  non-capturable Adam keeps them on the host by design)."""
  import dataclasses

  import torch

  from agents_tpu_torch.utils import nest_utils

  replay = getattr(state, "replay_state", None)
  out = [x for x in nest_utils.flatten(
      (state.driver_state, replay.storage if replay else (),
       state.metric_states)) if isinstance(x, torch.Tensor)]
  for field in dataclasses.fields(state.agent_state):
    value = getattr(state.agent_state, field.name)
    if isinstance(value, torch.nn.Module):
      out += list(value.parameters()) + list(value.buffers())
    elif isinstance(value, torch.optim.Optimizer):
      for per_param in value.state.values():
        out += [v for k, v in per_param.items()
                if isinstance(v, torch.Tensor) and k != "step"]
    elif isinstance(value, torch.Tensor) or dataclasses.is_dataclass(value):
      out += [x for x in nest_utils.flatten(value)
              if isinstance(x, torch.Tensor)]
  return out


def check_step_types(loop, state):
  """Legal transitions over the whole ring: post-LAST is FIRST, and each
  frame's next step type is the following frame's step type."""
  import torch

  from agents_tpu_torch.replay_buffers.uniform_replay import ReplayState
  from agents_tpu_torch.trajectories.time_step import StepType

  # Only the two step-type leaves: a gather of every leaf would copy the
  # whole ring (7.4 GB of frames at the pixel bench point).
  storage, count = state.replay_state.storage, state.replay_state.count
  st, nst = loop.replay.gather_all(ReplayState(
      (storage.step_type, storage.next_step_type), count))
  size = loop.replay.size(state.replay_state)
  st, nst = st[:, :size], nst[:, :size]                     # [B, size]
  bad = int(((st == StepType.LAST) != (nst == StepType.FIRST)).sum())
  bad += int((nst[:, :-1] != st[:, 1:]).sum())
  newest = (state.replay_state.count - 1) % loop.replay.capacity
  bad += int((state.replay_state.storage.next_step_type[newest]
              != state.driver_state.time_step.step_type).sum())
  return bad, int((st == StepType.LAST).sum())


def profile_call(fn, count, unit, name="profile_trace.json"):
  """Run `fn()`, which does `count` `unit`s of work, under
  `torch.profiler`: (its result, per-unit stats: wall and device-busy ms,
  the busy share, device ops, trace events by category and the top device
  ops), read from the chrome trace written under ``runs/``."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  os.makedirs(RUNS_DIR, exist_ok=True)
  trace = os.path.join(RUNS_DIR, name)
  prof.export_chrome_trace(trace)
  with open(trace) as f:
    events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
  # Device work only: kernels, copies and sets. Annotations on the device
  # timeline span work that is already counted; the union of the spans is
  # the busy time.
  spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("cat") in DEVICE_ACTIVITIES)
  busy_us, busy_end, by_name = 0.0, float("-inf"), {}
  for start, end, op in spans:
    busy_us += max(0.0, end - max(start, busy_end))
    busy_end = max(busy_end, end)
    total, calls = by_name.get(op, (0.0, 0))
    by_name[op] = (total + end - start, calls + 1)
  top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
  categories = {}
  for e in events:
    categories[e.get("cat")] = categories.get(e.get("cat"), 0) + 1
  return result, {
      f"{unit}s": count,
      f"wall_ms_per_{unit}": wall_us / 1e3 / count,
      f"device_ms_per_{unit}": busy_us / 1e3 / count,
      "device_busy_share": busy_us / wall_us,
      f"device_ops_per_{unit}": len(spans) / count,
      f"trace_events_per_{unit}": {str(k): v / count
                                   for k, v in categories.items()},
      "top": [{"name": op[:80], f"device_ms_per_{unit}": us / 1e3 / count,
               f"calls_per_{unit}": c / count}
              for op, (us, c) in top]}


def profile_window(loop, state, iterations):
  """Device-busy share and the top device ops over `iterations` loop
  iterations (`profile_call`)."""
  (state, _), stats = profile_call(lambda: loop.run(state, iterations),
                                   iterations, "iteration")
  return state, stats


def timed_windows(loop, state, iterations, windows=TIMED_WINDOWS):
  """`iterations` iterations under ``set_sync_debug_mode("error")``, in
  `windows` windows each ended by a synchronize outside the debug mode, so
  the spread between windows shows beside the mean. Returns (state, the
  last window's losses, ms/iteration of each window)."""
  import torch

  window_ms, window = [], iterations // windows
  for _ in range(windows):
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    state, losses = loop.run(state, window)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    window_ms.append((time.perf_counter() - t0) * 1e3 / window)
  return state, losses, window_ms


def phase_main_and_learn(card):
  import torch

  loop = build_loop("cuda", B_MAIN, **MAIN)
  t_init = time.perf_counter()
  state = loop.init(seed=0, initial_collect_steps=100)
  state, losses = loop.run(state, WARMUP_ITERATIONS)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t_init

  state, losses, window_ms = timed_windows(loop, state, TIMED_ITERATIONS)
  dt = sum(window_ms) / len(window_ms) * TIMED_ITERATIONS / 1e3

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


def conv_forward_flops(size, frames, num_actions, convs, fc):
  """Analytic FLOPs of one Q-network forward on one frame, as
  ``bench.py:conv_bench`` counts them: SAME padding, ceil(dim / stride)
  outputs, 2 FLOPs per multiply-add."""
  total, cin = 0, frames
  for filters, kernel, stride in convs:
    size = -(-size // stride)
    total += size * size * filters * kernel * kernel * cin * 2
    cin = filters
  width = size * size * cin
  for out in tuple(fc) + (num_actions,):
    total += width * out * 2
    width = out
  return total


def free_card():
  import gc

  import torch

  gc.collect()
  torch.cuda.empty_cache()


def phase_conv_parity(card):
  import numpy as np
  import torch

  from agents_tpu_torch.environments.classic import SyntheticPixels
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.utils import convert
  from examples.dqn_pixels_torch import Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  t0 = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True

  # (a) the pixel loop, fp32, card against CPU.
  size = CONV_PARITY["pixels_size"]
  state_dict = convert.q_params_to_state_dict(numpy_q_params(
      np.random.RandomState(1), (512,), num_actions=6, convs=MNIH15,
      image=(size, size, 4)))
  runs = run_on_both(lambda device: pixel_loop(Config(device=device,
                                                       **CONV_PARITY)),
                     lambda loop: loop.agent.q_network.load_state_dict(
                         state_dict),
                     initial_collect_steps=16, iterations=3)
  diffs, mismatched = compare_runs(runs, CONV_RTOL, CONV_ATOL)
  worst = max(diffs, key=diffs.get)
  storage = runs["cuda"][1].replay_state.storage
  torch.backends.cudnn.deterministic = deterministic

  # (b) the bf16 bench network on 32 random 84x84x4 frames.
  rng = np.random.RandomState(2)
  state_dict = convert.q_params_to_state_dict(numpy_q_params(
      rng, (512,), num_actions=6, convs=MNIH15, image=(84, 84, 4)))
  frames = torch.from_numpy(rng.randint(0, 256, (32, 84, 84, 4), np.uint8))
  env = SyntheticPixels()
  q = {}
  for device in ("cpu", "cuda"):
    net = make_q_network(
        env.observation_spec(), env.action_spec(), MNIH15, (512,),
        dtype=torch.bfloat16,
        preprocessing=lambda x: x.to(torch.bfloat16) / 255.0, device=device)
    net.load_state_dict(state_dict)
    with torch.no_grad():
      q[device] = net(frames.to(device))[0].cpu()
  q_diff = max_diff(q["cpu"], q["cuda"])
  top2 = q["cpu"].topk(2, dim=-1).values
  clear = (top2[:, 0] - top2[:, 1]) > BF16_ATOL
  action_mismatch = int((q["cpu"].argmax(-1) != q["cuda"].argmax(-1))[
      clear].sum())
  ok = not mismatched and q_diff <= BF16_ATOL and action_mismatch == 0
  emit("conv_parity", card=card,
       fp32={"pixels": f"{size}x{size}x4", "conv": MNIH15, "fc": [512],
             "batch_size": CONV_PARITY["env_batch_size"],
             "ring": CONV_PARITY["replay_capacity"],
             "sample": CONV_PARITY["sample_batch_size"], "iterations": 3,
             "rtol": CONV_RTOL, "atol": CONV_ATOL,
             "largest_float_diff": {"name": worst, "abs": diffs[worst]},
             "loss_diff": diffs["losses"],
             "replay_observation_dtype": str(storage.observation.dtype),
             "mismatched": mismatched},
       bf16={"frames": 32, "atol": BF16_ATOL, "q_max_abs_diff": q_diff,
             "frames_with_top2_gap_over_atol": int(clear.sum()),
             "greedy_action_mismatches": action_mismatch},
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("conv_parity", "card and CPU disagree on the conv path")


def phase_conv_main(card):
  import torch

  from examples.dqn_pixels_torch import Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  t_phase = time.perf_counter()
  cfg = Config()
  torch.cuda.reset_peak_memory_stats()
  loop = pixel_loop(cfg)
  t_init = time.perf_counter()
  state = loop.init(seed=cfg.seed, initial_collect_steps=CONV_INITIAL)
  state, losses = loop.run(state, CONV_WARMUP)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t_init

  state, losses, window_ms = timed_windows(loop, state, CONV_TIMED)
  ms = sum(window_ms) / len(window_ms)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  expected_count = CONV_INITIAL + CONV_WARMUP + CONV_TIMED
  bad_transitions, lasts = check_step_types(loop, state)
  replay_count = state.replay_state.count
  obs = state.replay_state.storage.observation
  obs_bytes = obs.numel() * obs.element_size()
  expected_bytes = (cfg.replay_capacity * cfg.env_batch_size
                    * cfg.pixels_size ** 2 * cfg.pixels_frames)
  ok = (not off_card and finite and bad_transitions == 0
        and replay_count == expected_count and obs.dtype == torch.uint8
        and obs_bytes == expected_bytes)
  state, prof = profile_window(loop, state, CONV_PROFILED)
  fwd = conv_forward_flops(cfg.pixels_size, cfg.pixels_frames,
                           cfg.pixels_actions, cfg.conv_layer_params,
                           cfg.fc_layer_params)
  # Collect forward on B rows; train: online forward, backward (about 2x
  # forward) and target forward on S windows (``bench.py:252-254``).
  flops = fwd * (cfg.env_batch_size + 4 * cfg.sample_batch_size)
  emit("conv_main", card=card, batch_size=cfg.env_batch_size,
       sample_batch_size=cfg.sample_batch_size, ring=cfg.replay_capacity,
       conv=cfg.conv_layer_params, fc=cfg.fc_layer_params, dtype=cfg.dtype,
       timed_iterations=CONV_TIMED, sync_debug_mode="error",
       ms_per_iteration=ms, window_ms_per_iteration=window_ms,
       env_steps_per_s=cfg.env_batch_size * 1e3 / ms,
       train_frames_per_s=cfg.sample_batch_size * 1e3 / ms,
       model_gflop_per_forward_frame=fwd / 1e9,
       model_gflop_per_iteration=flops / 1e9,
       model_tflop_per_s=flops / ms / 1e9,
       model_flops_share_of_989_tflops_bf16_peak=flops / ms / 1e9 / 989.0,
       init_and_warmup_s=init_s, tensors_off_card=off_card,
       losses_finite=finite, replay_count=replay_count,
       expected_replay_count=expected_count,
       replay_observation={"dtype": str(obs.dtype), "shape": list(obs.shape),
                           "bytes": obs_bytes,
                           "expected_bytes": expected_bytes},
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts,
       peak_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
       profile=prof, seconds=time.perf_counter() - t_phase, ok=ok)
  if not ok:
    fail("conv_main", "pixel bench point checks failed")


def phase_conv_learn(card):
  import torch

  from examples.dqn_pixels_torch import CATCH, Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  t0 = time.perf_counter()
  cfg = Config(**CATCH)
  loop = pixel_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  iterations, ret = 0, -1.0
  while iterations < CATCH_ITERATIONS:
    state, losses = loop.run(state, CATCH_CHUNK)
    iterations += CATCH_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    if ret > 0.5:
      break
  learn_s = time.perf_counter() - t0
  out = loop.evaluate(state, cfg.seed + 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret > CATCH_GATE and finite and episodes == 30
  emit("conv_learn", card=card, env=f"catch {cfg.catch_rows}x"
       f"{cfg.catch_columns}", batch_size=cfg.env_batch_size,
       iterations=iterations, last100_average_return=ret, gate=CATCH_GATE,
       losses_finite=finite, ms_per_iteration=learn_s * 1e3 / iterations,
       eval_episodes=episodes, eval_average_return=float(out["AverageReturn"]),
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("conv_learn", f"Catch return {ret} (gate {CATCH_GATE}), "
         f"{episodes} eval episodes of 30")


def phase_c51(card):
  import torch

  from examples.dqn_pixels_torch import Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  t0 = time.perf_counter()
  cfg = Config(agent="c51")
  loop = pixel_loop(cfg)
  state = loop.init(seed=cfg.seed, initial_collect_steps=CONV_INITIAL)
  state, losses = loop.run(state, C51_WARMUP)
  torch.cuda.synchronize()
  state, losses, window_ms = timed_windows(loop, state, C51_TIMED, 1)
  finite = bool(torch.isfinite(losses).all())
  expected_count = CONV_INITIAL + C51_WARMUP + C51_TIMED
  ok = finite and state.replay_state.count == expected_count
  emit("c51", card=card, num_atoms=cfg.num_atoms,
       support=[cfg.min_q_value, cfg.max_q_value],
       batch_size=cfg.env_batch_size, sample_batch_size=cfg.sample_batch_size,
       ring=cfg.replay_capacity, timed_iterations=C51_TIMED,
       sync_debug_mode="error", ms_per_iteration=window_ms[0],
       losses_finite=finite, last_loss=float(losses[-1]),
       replay_count=state.replay_state.count,
       expected_replay_count=expected_count,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("c51", "C51 at the pixel bench point failed its checks")


def numpy_sac_params(rng, actor_fc, critic_fc, obs_dim=3, act_dim=1):
  """Flax-shaped SAC actor and two critic param trees drawn with numpy."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, shape[-1:]).astype(np.float32)}

  def stack(width, widths):
    layers = []
    for out in widths:
      layers.append(layer((width, out), math.sqrt(3.0 / width)))
      width = out
    return layers, width

  encoder, width = stack(obs_dim, actor_fc)
  actor = {"params": {
      "EncoderModule_0": {f"Dense_{i}": d for i, d in enumerate(encoder)},
      "TanhNormalProjection_0": {"Dense_0": layer(
          (width, 2 * act_dim), math.sqrt(3.0 / width))}}}

  def critic():
    layers, width = stack(obs_dim + act_dim, critic_fc)
    layers.append(layer((width, 1), 0.003))
    return {"params": {f"Dense_{i}": d for i, d in enumerate(layers)}}

  return actor, critic(), critic()


def sac_train_step_flops(sample_batch_size, obs_dim, act_dim, actor_fc,
                         critic_fc):
  """Analytic FLOPs of one SAC train step, 2 per multiply-add of the dense
  layers. Per sampled row, with A and C one actor and one critic forward:
  the critic targets take the actor and two target critics (A + 2C); the
  critic loss two critic forwards and their backward, about twice the
  forward (2C + 4C); the actor loss the actor and two critics forward
  (A + 2C), the critics' backward to the actions (2C) and the actor's
  backward (2A). In all 4A + 12C."""
  def macs(width, widths):
    total = 0
    for out in widths:
      total += width * out
      width = out
    return total

  a = macs(obs_dim, tuple(actor_fc) + (2 * act_dim,))
  c = macs(obs_dim + act_dim, tuple(critic_fc) + (1,))
  return 2 * sample_batch_size * (4 * a + 12 * c)


def phase_sac_parity(card):
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert
  from examples.sac_pendulum_torch import Config
  from examples.sac_pendulum_torch import build_loop as sac_loop

  t0 = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = Config(**SAC_PARITY)
  actor, critic1, critic2 = numpy_sac_params(
      np.random.RandomState(3), cfg.actor_fc_layers,
      cfg.critic_joint_fc_layers)

  def load(loop):
    agent = loop.agent
    agent.actor_network.load_state_dict(
        convert.sac_actor_params_to_state_dict(actor))
    agent.critic_network.load_state_dict(
        convert.sac_critic_params_to_state_dict(critic1))
    agent.critic_network_2.load_state_dict(
        convert.sac_critic_params_to_state_dict(critic2))

  runs = run_on_both(
      lambda device: sac_loop(dataclasses.replace(cfg, device=device)),
      load, initial_collect_steps=16, iterations=3)
  diffs, mismatched = compare_runs(runs, SAC_RTOL, SAC_ATOL, sac_tensors)
  worst = max(diffs, key=diffs.get)
  gstate = runs["cuda"][1]
  ok = not mismatched and gstate.agent_state.train_step == 3 * 2
  emit("sac_parity", card=card, actor=list(cfg.actor_fc_layers),
       critic=list(cfg.critic_joint_fc_layers),
       batch_size=cfg.env_batch_size, ring=cfg.replay_capacity,
       sample=cfg.sample_batch_size,
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       iterations=3, rtol=SAC_RTOL, atol=SAC_ATOL,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       loss_diff=diffs["losses"], log_alpha_diff=diffs["log_alpha"],
       compared=len(diffs), mismatched=mismatched,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("sac_parity", f"card and CPU disagree on {mismatched}")


def phase_sac_main(card):
  import torch

  from examples.sac_pendulum_torch import Config
  from examples.sac_pendulum_torch import build_loop as sac_loop

  t_phase = time.perf_counter()
  cfg = Config()
  loop = sac_loop(cfg)
  t_init = time.perf_counter()
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  state, losses = loop.run(state, SAC_WARMUP)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t_init

  state, losses, window_ms = timed_windows(loop, state, SAC_TIMED)
  ms = sum(window_ms) / len(window_ms)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  log_alpha = float(state.agent_state.log_alpha.detach())
  finite = bool(torch.isfinite(losses).all()) and math.isfinite(log_alpha)
  expected_count = cfg.initial_collect_steps + SAC_WARMUP + SAC_TIMED
  bad_transitions, lasts = check_step_types(loop, state)
  replay_count = state.replay_state.count
  expected_steps = (SAC_WARMUP + SAC_TIMED) * cfg.train_steps_per_iteration
  ok = (not off_card and finite and bad_transitions == 0
        and replay_count == expected_count
        and state.agent_state.train_step == expected_steps)
  state, prof = profile_window(loop, state, SAC_PROFILED)
  steps = cfg.train_steps_per_iteration
  flops = sac_train_step_flops(cfg.sample_batch_size, 3, 1,
                               cfg.actor_fc_layers,
                               cfg.critic_joint_fc_layers)
  emit("sac_main", card=card, batch_size=cfg.env_batch_size,
       ring=cfg.replay_capacity, sample_batch_size=cfg.sample_batch_size,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       train_steps_per_iteration=steps, timed_iterations=SAC_TIMED,
       sync_debug_mode="error", ms_per_iteration=ms,
       window_ms_per_iteration=window_ms,
       ms_per_train_step=ms / steps,
       env_steps_per_s=cfg.env_batch_size * 1e3 / ms,
       train_steps_per_s=steps * 1e3 / ms,
       operator_records_per_train_step=prof["trace_events_per_iteration"].get(
           "cpu_op", 0.0) / steps,
       device_ops_per_train_step=prof["device_ops_per_iteration"] / steps,
       model_gflop_per_train_step=flops / 1e9,
       model_tflop_per_s=flops * steps / ms / 1e9,
       init_and_warmup_s=init_s, tensors_off_card=off_card,
       losses_finite=finite, last_loss=float(losses[-1]),
       log_alpha=log_alpha, replay_count=replay_count,
       expected_replay_count=expected_count,
       train_step=state.agent_state.train_step,
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts, profile=prof,
       seconds=time.perf_counter() - t_phase, ok=ok)
  if not ok:
    fail("sac_main", "SAC bench point checks failed")


def phase_sac_learn(card):
  import torch

  from examples.sac_pendulum_torch import LIVE, Config
  from examples.sac_pendulum_torch import build_loop as sac_loop

  t0 = time.perf_counter()
  cfg = Config(**LIVE)
  loop = sac_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  iterations, ret, points = 0, -math.inf, []
  while iterations < SAC_LEARN_ITERATIONS:
    state, losses = loop.run(state, SAC_LEARN_CHUNK)
    iterations += SAC_LEARN_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    points.append([iterations, ret])
    if ret >= SAC_LEARN_GATE:
      break
  learn_s = time.perf_counter() - t0
  t_eval = time.perf_counter()
  out = loop.evaluate(state, cfg.seed + 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  eval_return = float(out["AverageReturn"])
  torch.cuda.synchronize()
  finite = bool(torch.isfinite(losses).all())
  ok = ret >= SAC_LEARN_GATE and finite and episodes == 30
  emit("sac_learn", card=card, batch_size=cfg.env_batch_size,
       sample_batch_size=cfg.sample_batch_size,
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       iterations=iterations, last20_average_return=ret,
       gate=SAC_LEARN_GATE, points=points, losses_finite=finite,
       log_alpha=float(state.agent_state.log_alpha.detach()),
       ms_per_iteration=learn_s * 1e3 / iterations, learn_seconds=learn_s,
       eval_episodes=episodes, eval_average_return=eval_return,
       eval_seconds=time.perf_counter() - t_eval,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("sac_learn", f"last-20 return {ret} (gate {SAC_LEARN_GATE}), "
         f"{episodes} eval episodes of 30")


def numpy_ppo_params(rng, fc, obs_dim, num_actions=None, act_dim=None,
                     std_bias=0.0):
  """Flax-shaped PPO actor and value trees drawn with numpy: a categorical
  head over `num_actions`, or a Normal head of `act_dim` with a
  state-independent `std_bias`."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, shape[-1:]).astype(np.float32)}

  def encoder():
    layers, width = {}, obs_dim
    for i, out in enumerate(fc):
      layers[f"Dense_{i}"] = layer((width, out), math.sqrt(3.0 / width))
      width = out
    return layers, width

  enc, width = encoder()
  if num_actions is not None:
    head = {"CategoricalProjection_0": {"Dense_0": layer((width, num_actions),
                                                         0.1)}}
  else:
    head = {"NormalProjection_0": {
        "Dense_0": layer((width, act_dim), 0.1),
        "std_bias": np.full(act_dim, std_bias, np.float32)}}
  value_enc, width = encoder()
  return ({"params": {"EncoderModule_0": enc, **head}},
          {"params": {"EncoderModule_0": value_enc,
                      "Dense_0": layer((width, 1), 0.03)}})


def ppo_tensors(agent_state):
  """The actor and value networks' tensors, the Adam moments and step
  counts, the normalizer states, beta, the learning rate and the train
  step, by name."""
  import dataclasses

  import torch

  out = {f"{net}.{k}": v for net in ("actor_network", "value_network")
         for k, v in getattr(agent_state, net).state_dict().items()}
  optimizer = agent_state.optimizer
  params = [p for g in optimizer.param_groups for p in g["params"]]
  for i, p in enumerate(params):
    for k, v in optimizer.state[p].items():
      out[f"adam.{i}.{k}"] = v
  for field in ("obs_norm_state", "reward_norm_state"):
    state = getattr(agent_state, field)
    for f in dataclasses.fields(state):
      out[f"{field}.{f.name}"] = getattr(state, f.name)
  out["kl_beta"] = agent_state.kl_beta
  out["lr"] = torch.tensor(optimizer.param_groups[0]["lr"], dtype=torch.float64)
  out["train_step"] = torch.tensor(agent_state.train_step)
  return out


def policy_outputs(agent, agent_state, experience):
  """The collect policy's distribution parameters and value predictions
  on every frame of `experience` [B, T] (flattened to B*T rows)."""
  import torch

  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import nest_utils

  flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
  time_step = ts.TimeStep(
      step_type=flat(experience.step_type),
      reward=flat(experience.reward), discount=flat(experience.discount),
      observation=nest_utils.tree_map(flat, experience.observation))
  with torch.no_grad():
    step = agent.collect_policy.distribution(agent.policy_params(agent_state),
                                             time_step)
  return nest_utils.flatten(step.info)


def phase_ppo_parity(card):
  """The PPO learner on the card against the CPU on the same rollouts.

  The CPU runs the loop and records its draws; for each of its rollouts
  the card computes its collect policy's outputs on the rollout's frames
  (before the train step, from its own networks) and trains on a copy of
  the rollout with the CPU's permutations. Feeding both the same rollouts
  keeps CartPole's and Pendulum's dynamics out of the comparison: over a
  rollout of 128 or 257 steps they amplify the last-bit differences of
  the card's `sin`/`cos` past any float tolerance, so a card that collects
  its own rollouts parts from the CPU.
  """
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert, nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
  from examples.ppo_cartpole_torch import SCHULMAN17_PENDULUM, Config
  from examples.ppo_cartpole_torch import build_loop as ppo_loop

  t0 = time.perf_counter()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out, ok = {}, True
  cases = (
      ("cartpole", Config(), PPO_PARITY_ITERATIONS,
       dict(obs_dim=4, num_actions=2)),
      ("schulman17_pendulum",
       Config(**{**SCHULMAN17_PENDULUM, **PPO_PARITY_SCHULMAN17}), 1,
       dict(obs_dim=3, act_dim=1,
            std_bias=math.log(math.exp(0.35) - 1.0))))
  for i, (name, cfg, iterations, shape) in enumerate(cases):
    actor, value = numpy_ppo_params(np.random.RandomState(5 + i),
                                    cfg.actor_fc_layers, **shape)
    loops = {}
    for role, device in (("host", "cpu"), ("card", "cuda")):
      loop = ppo_loop(dataclasses.replace(cfg, device=device))
      loop.agent.actor_network.load_state_dict(
          convert.actor_params_to_state_dict(actor))
      loop.agent.value_network.load_state_dict(
          convert.value_params_to_state_dict(value))
      loops[role] = loop
    cloop, gagent = loops["host"], loops["card"].agent
    draws = RecordingDraws(Draws(0, "cpu"))
    cstate, gstate = cloop.init(draws=draws), gagent.init()
    diffs, relative, mismatched = {}, {}, []

    def compare(tag, a, b):
      # Tensor-wise: max|a - b| <= atol + rtol * max|b|. The value targets
      # run to hundreds and their gradients to thousands, so an element
      # near zero of such a tensor carries rounding far above any
      # element-wise atol. The Adam moments sum those gradients, whose
      # first-layer sums over 508 rows cancel: rtol 1e-3 for them.
      a, b = a.cpu(), b.cpu()
      if a.dtype.is_floating_point:
        diffs[tag] = max_diff(a, b)
        scale = float(b.double().abs().max()) if b.numel() else 0.0
        relative[tag] = diffs[tag] / scale if scale else diffs[tag]
        rtol = PPO_MOMENT_RTOL if ".exp_avg" in tag else PPO_RTOL
        if diffs[tag] > PPO_ATOL + rtol * scale:
          mismatched.append(tag)
      elif not torch.equal(a, b):
        mismatched.append(tag)

    for it in range(iterations):
      cstate, experience = cloop.collect(cstate)
      gexperience = nest_utils.tree_map(lambda x: x.to("cuda"), experience)
      for j, (a, b) in enumerate(zip(
          policy_outputs(gagent, gstate, gexperience),
          policy_outputs(cloop.agent, cstate.agent_state, experience))):
        compare(f"iteration{it}.policy_info.{j}", a, b)
      cagent_state, cinfo = cloop.agent.train(cstate.agent_state, experience,
                                              draws=draws)
      cstate = dataclasses.replace(cstate, agent_state=cagent_state)
      perms = draws.records["ppo_permutation"][-cfg.num_epochs:]
      gstate, ginfo = gagent.train(
          gstate, gexperience,
          draws=ReplayDraws({"ppo_permutation": perms}, "cuda"))
      compare(f"iteration{it}.loss", cinfo.loss, ginfo.loss)
      ctensors, gtensors = (ppo_tensors(s) for s in (cagent_state, gstate))
      for k in ctensors:
        compare(f"iteration{it}.{k}", ctensors[k], gtensors[k])
    worst = max(diffs, key=diffs.get)
    worst_relative = max(relative, key=relative.get)
    case_ok = not mismatched and gstate.train_step == iterations
    ok = ok and case_ok
    out[name] = {
        "batch_size": cfg.env_batch_size, "rollout_length": cfg.rollout_length,
        "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches,
        "fc": list(cfg.actor_fc_layers), "iterations": iterations,
        "adam_steps": iterations * cfg.num_epochs * cfg.num_minibatches,
        "largest_float_diff": {"name": worst, "abs": diffs[worst]},
        "largest_relative_diff": {"name": worst_relative,
                                  "of_max_abs": relative[worst_relative]},
        "loss_diff": max(v for k, v in diffs.items() if k.endswith(".loss")),
        "policy_info_diff": max(v for k, v in diffs.items()
                                if ".policy_info." in k),
        "compared": len(diffs), "mismatched": mismatched, "ok": case_ok}
  emit("ppo_parity", card=card, rtol=PPO_RTOL, atol=PPO_ATOL,
       adam_moment_rtol=PPO_MOMENT_RTOL,
       criterion="max|card - cpu| <= atol + rtol * max|cpu| per tensor", **out,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("ppo_parity", "card and CPU disagree on the PPO path")


def iteration_split(loop, state, repeats=1):
  """One iteration timed in parts, each ended by a synchronize: the
  rollout (collect), returns and advantages (GAE) alone, then the whole
  `agent.train` (normalizers, GAE again and the epochs), ms each (the
  mean of `repeats`). Returns (state, split)."""
  import torch

  split = {"collect_ms": 0.0, "gae_ms": 0.0, "train_ms": 0.0}
  for _ in range(repeats):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, experience = loop.collect(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop.agent.compute_return_and_advantage(state.agent_state, experience)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    agent_state, _ = loop.agent.train(state.agent_state, experience,
                                      draws=state.draws)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    state = dataclasses.replace(state, agent_state=agent_state)
    for k, dt in (("collect_ms", t1 - t0), ("gae_ms", t2 - t1),
                  ("train_ms", t3 - t2)):
      split[k] += dt * 1e3 / repeats
  return state, split


def rollout_checks(experience):
  """A rollout's legal step types (each frame's next step type is the
  following frame's step type; post-LAST is FIRST) and its shape."""
  from agents_tpu_torch.trajectories.time_step import StepType

  st, nst = experience.step_type, experience.next_step_type
  bad = int((nst[:, :-1] != st[:, 1:]).sum())
  bad += int(((st == StepType.LAST) != (nst == StepType.FIRST)).sum())
  return {"shape": list(st.shape), "illegal_step_type_transitions": bad,
          "last_frames": int((st == StepType.LAST).sum())}


def phase_ppo_main(card):
  import statistics

  import torch

  from examples.ppo_cartpole_torch import Config
  from examples.ppo_cartpole_torch import build_loop as ppo_loop

  t_phase = time.perf_counter()
  cfg = Config()
  loop = ppo_loop(cfg)
  state = loop.init(cfg.seed)
  state, losses = loop.run(state, PPO_WARMUP)
  torch.cuda.synchronize()
  state, losses, window_ms = timed_windows(loop, state,
                                           PPO_TIMED_WINDOWS * PPO_WINDOW,
                                           PPO_TIMED_WINDOWS)
  ms = statistics.median(window_ms)
  iterations = PPO_WARMUP + PPO_TIMED_WINDOWS * PPO_WINDOW
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  state, split = iteration_split(loop, state)
  state, prof = profile_window(loop, state, PPO_PROFILED)
  state, experience = loop.collect(state)
  mb_steps = cfg.num_epochs * cfg.num_minibatches
  (agent_state, _), train_prof = profile_call(
      lambda: loop.agent.train(state.agent_state, experience,
                               draws=state.draws), mb_steps, "minibatch_step",
      name="profile_train.json")
  _, gae_prof = profile_call(
      lambda: loop.agent.compute_return_and_advantage(agent_state,
                                                      experience),
      1, "call", name="profile_gae.json")
  state = dataclasses.replace(state, agent_state=agent_state)
  rollout = rollout_checks(experience)
  iterations += 1 + PPO_PROFILED + 1
  ok = (not off_card and finite and rollout["illegal_step_type_transitions"]
        == 0 and state.agent_state.train_step == iterations)
  frames = cfg.env_batch_size * cfg.rollout_length
  emit("ppo_main", card=card, batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, epochs=cfg.num_epochs,
       minibatches=cfg.num_minibatches,
       minibatch_size=cfg.env_batch_size * (cfg.rollout_length - 1)
       // cfg.num_minibatches, fc=list(cfg.actor_fc_layers),
       sync_debug_mode="error", timed_windows=PPO_TIMED_WINDOWS,
       iterations_per_window=PPO_WINDOW, ms_per_iteration_median=ms,
       window_ms_per_iteration=window_ms, env_steps_per_s=frames * 1e3 / ms,
       minibatch_steps_per_s=mb_steps * 1e3 / ms, split_ms=split,
       profile=prof,
       train_operator_records_per_minibatch_step=train_prof[
           "trace_events_per_minibatch_step"].get("cpu_op", 0.0),
       train_device_ops_per_minibatch_step=train_prof[
           "device_ops_per_minibatch_step"],
       train_profile=train_prof,
       gae={"steps": cfg.rollout_length - 1,
            "device_ops": gae_prof["device_ops_per_call"],
            "device_ms": gae_prof["device_ms_per_call"],
            "wall_ms": gae_prof["wall_ms_per_call"]},
       tensors_off_card=off_card, losses_finite=finite,
       last_loss=float(losses[-1]), rollout=rollout,
       train_step=state.agent_state.train_step,
       seconds=time.perf_counter() - t_phase, ok=ok)
  if not ok:
    fail("ppo_main", "PPO CartPole point checks failed")
  return cfg, loop, state, iterations


def phase_ppo_learn(card, cfg, loop, state, iterations):
  import torch

  from examples.ppo_cartpole_torch import evaluate

  t0 = time.perf_counter()
  ret = float(loop.results(state)["AverageReturn"])
  points = [[iterations, ret]]
  while ret < PPO_LEARN_GATE and iterations < PPO_LEARN_ITERATIONS:
    state, losses = loop.run(state, PPO_LEARN_CHUNK)
    iterations += PPO_LEARN_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    points.append([iterations, ret])
  learn_s = time.perf_counter() - t0
  t_eval = time.perf_counter()
  out = evaluate(cfg, loop, state, cfg.seed + 101, 30)
  episodes = int(out["NumberOfEpisodes"])
  torch.cuda.synchronize()
  ok = ret >= PPO_LEARN_GATE and episodes == 30
  emit("ppo_learn", card=card, batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, iterations=iterations,
       last20_average_return=ret, gate=PPO_LEARN_GATE,
       budget=PPO_LEARN_ITERATIONS, points=points, learn_seconds=learn_s,
       eval_episodes=episodes, eval_envs=cfg.num_eval_envs,
       eval_average_return=float(out["AverageReturn"]),
       eval_average_episode_length=float(out["AverageEpisodeLength"]),
       eval_seconds=time.perf_counter() - t_eval,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("ppo_learn", f"last-20 return {ret} (gate {PPO_LEARN_GATE} within "
         f"{PPO_LEARN_ITERATIONS} iterations), {episodes} eval episodes of 30")


def phase_ppo_schulman17(card):
  import torch

  from examples.ppo_cartpole_torch import SCHULMAN17_PENDULUM, Config
  from examples.ppo_cartpole_torch import build_loop as ppo_loop

  t_phase = time.perf_counter()
  cfg = Config(**SCHULMAN17_PENDULUM)
  loop = ppo_loop(cfg)
  state = loop.init(cfg.seed)
  state, losses = loop.run(state, 1)
  torch.cuda.synchronize()
  state, losses, window_ms = timed_windows(loop, state, SCHULMAN17_TIMED,
                                           SCHULMAN17_TIMED)
  ms = sum(window_ms) / len(window_ms)
  finite = bool(torch.isfinite(losses).all())
  state, split = iteration_split(loop, state)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  mb_steps = cfg.num_epochs * cfg.num_minibatches
  lr = state.agent_state.optimizer.param_groups[0]["lr"]
  expected_lr = cfg.learning_rate * (1.0 - (SCHULMAN17_TIMED + 2) * mb_steps
                                     / (cfg.num_iterations * mb_steps))
  ok = (finite and not off_card
        and state.agent_state.train_step == SCHULMAN17_TIMED + 2
        and math.isclose(lr, expected_lr, rel_tol=1e-9))
  frames = cfg.env_batch_size * cfg.rollout_length
  emit("ppo_schulman17", card=card, env="pendulum (for HalfCheetah-v5)",
       batch_size=cfg.env_batch_size, rollout_length=cfg.rollout_length,
       epochs=cfg.num_epochs, minibatches=cfg.num_minibatches,
       minibatch_size=(cfg.rollout_length - 1) // cfg.num_minibatches,
       fc=list(cfg.actor_fc_layers), activation=cfg.activation,
       sync_debug_mode="error", timed_iterations=SCHULMAN17_TIMED,
       ms_per_iteration=ms, window_ms_per_iteration=window_ms,
       env_steps_per_s=frames * 1e3 / ms,
       minibatch_steps_per_s=mb_steps * 1e3 / ms, split_ms=split,
       collect_ms_per_env_step=split["collect_ms"] / cfg.rollout_length,
       train_ms_per_minibatch_step=split["train_ms"] / mb_steps,
       losses=[float(x) for x in losses], losses_finite=finite,
       learning_rate=lr, expected_learning_rate=expected_lr,
       tensors_off_card=off_card, train_step=state.agent_state.train_step,
       seconds=time.perf_counter() - t_phase, ok=ok)
  if not ok:
    fail("ppo_schulman17", "schulman17 Pendulum point checks failed")


def build_reinforce_loop(device="cuda", seed=0):
  """REINFORCE with a (64, 64) value baseline on CartPole: B=32, T=128,
  Adam 1e-3, gamma 0.99."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.reinforce import ReinforceAgent
  from agents_tpu_torch.networks import (make_actor_distribution_network,
                                         make_value_network)
  from agents_tpu_torch.train import OnPolicyTrainLoop
  from examples.ppo_cartpole_torch import Config, build_env

  env = build_env(Config(device=device), 32)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(seed)
  agent = ReinforceAgent(
      tss, asp,
      make_actor_distribution_network(tss.observation, asp,
                                      fc_layer_params=(64, 64),
                                      device=device, generator=generator),
      lambda p: torch.optim.Adam(p, lr=1e-3),
      value_network=make_value_network(tss.observation, (64, 64),
                                       device=device, generator=generator),
      gamma=0.99, device=device)
  return OnPolicyTrainLoop(env, agent, metrics.standard_collect_metrics(20),
                           rollout_length=128, device=device)


def phase_reinforce(card):
  import torch

  t0 = time.perf_counter()
  loop = build_reinforce_loop()
  state = loop.init(0)
  state, losses = loop.run(state, 1)
  torch.cuda.synchronize()
  state, losses, window_ms = timed_windows(loop, state, REINFORCE_TIMED,
                                           REINFORCE_TIMED)
  ms = sum(window_ms) / len(window_ms)
  finite = bool(torch.isfinite(losses).all())
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  ok = (finite and not off_card
        and state.agent_state.train_step == REINFORCE_TIMED + 1)
  emit("reinforce", card=card, batch_size=32, rollout_length=128,
       fc=[64, 64], value_baseline=True, sync_debug_mode="error",
       timed_iterations=REINFORCE_TIMED, ms_per_iteration=ms,
       window_ms_per_iteration=window_ms,
       env_steps_per_s=32 * 128 * 1e3 / ms,
       losses=[float(x) for x in losses], losses_finite=finite,
       tensors_off_card=off_card, train_step=state.agent_state.train_step,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("reinforce", "REINFORCE checks failed")


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
  del loop, state
  phase_conv_parity(card)
  phase_conv_main(card)
  free_card()
  phase_conv_learn(card)
  phase_c51(card)
  free_card()
  phase_sac_parity(card)
  phase_sac_main(card)
  phase_sac_learn(card)
  free_card()
  phase_ppo_parity(card)
  cfg, loop, state, iterations = phase_ppo_main(card)
  phase_ppo_learn(card, cfg, loop, state, iterations)
  del loop, state
  phase_ppo_schulman17(card)
  phase_reinforce(card)
  emit("kernels", note="agents_tpu has no Pallas kernel at HEAD, so these "
       "paths have no hand-written kernel to build or check")
  print(json.dumps({"kernels": []}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
