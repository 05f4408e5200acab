#!/usr/bin/env python3
"""The PyTorch port's headline benchmark, the twin of ``bench.py``.

Run from the root of the repository: ``python3 bench_torch.py`` on one
CUDA card, or ``python3 bench_torch.py --device cpu --smoke`` to check it on
the CPU. It imports torch, numpy, `agents_tpu_torch` and the port's
examples only, and prints ONE JSON line with ``bench.py``'s keys:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

`value` is the env-steps/s of the fused DQN-CartPole bench point (one
collect step and one gradient step per iteration, ``bench.py:386-447``),
or 0 unless the last-20 average return reached 195: throughput without
learning does not count. `detail` holds the other three functions of
``bench.py``, each measured on the card here:

  bench_point              the bench point: B=4096, ring 512 per row,
                           sample 256; 8 warm-up chunks of 500 iterations,
                           4 timed chunks, a synchronize at each chunk's
                           edge (one per 500 iterations) and each chunk's
                           ms per iteration in `chunk_ms_per_iteration`.
  conv_bench               mnih15 + fc 512 in bfloat16 over 84x84x4 uint8
                           frames (B=128, sample 256) at rings of 512 and
                           2,048 per row (65k and 262k frames); `mfu` is the
                           analytic model FLOPs over the H100 SXM's
                           published dense bf16 peak, 989e12, beside the
                           card's power limit.
  host_atari_replay_probe  the 1M-frame host-RAM ring (28.2 GB of uint8):
                           fill, 2-step sample at batch 256, the sampled
                           batch's host-to-card copy, the hashed variant.
  sac_live_probe           SAC at UTD 1.0 through the async host-device
                           loop, pre-ramped until the trainer keeps up.

The loops are the examples' (``examples/dqn_cartpole_torch.py``,
``dqn_pixels_torch.py``, and ``sac_halfcheetah_torch.py``'s agent and
replay), at the `Config` fields below. Each timed chunk runs under
``torch.cuda.set_sync_debug_mode("error")`` on a card, so a sync inside
the loop raises instead of being timed.

Where it differs from ``bench.py`` on purpose:

- TF32 is off for matmul and cuDNN while each function runs, and `main`
  turns it off before anything is built (`detail.tf32`), as the timed
  phases of ``chip_smoke.py`` run.
- A failing function raises and the run exits non-zero; no
  ``{"error": ...}`` is recorded in the line.
- The SAC probe runs HalfCheetah-v5 through the port's `suite_gym` only
  when gymnasium and MuJoCo import. Otherwise it runs `random_halfcheetah`,
  a `RandomPyEnvironment` with HalfCheetah-v5's specs whose step costs far
  less than MuJoCo's, so its env-steps/s is no HalfCheetah rate (`env`
  says which ran).
- ``bench.py``'s ``sac_halfcheetah`` block (committed artifact numbers) is
  not carried over, nor XLA's cost analysis.

``--smoke`` cuts every function's depth and lists each cut under
`detail.reduced`, which is empty at full depth. On a card every width
stays; on the CPU the pixel bench also takes ``bench.py``'s smoke shapes
(B=8, sample 16, ring 64 per row, 20x20x4 frames), which `reduced` lists.
``--device`` defaults to "cuda" and raises without a card unless "cpu" is
asked for.
"""
import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

# TF-Agents' own collect-and-train loops on a host CPU, measured by
# benchmark/ref_dqn_baseline.py (train_eval.py:94-127's DQN point, best of
# two runs) and benchmark/ref_sac_baseline.py (the haarnoja18 SAC point,
# best case) on the host where the JAX package was developed. They are no
# accelerator's numbers, and they cannot be measured again without the
# TF-Agents tree and TensorFlow.
TF_AGENTS_CPU_ENV_STEPS_PER_S = 362.0
TF_AGENTS_SAC_CPU_ENV_STEPS_PER_S = 90.4

# NVIDIA's data sheet, H100 SXM: dense bf16 at the full 700 W.
H100_PEAK_FLOPS_BF16 = 989e12

MNIH15 = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
SOLVED_RETURN = 195.0
HALFCHEETAH_OBS, HALFCHEETAH_ACT = 17, 6

# `bench.py:401-415`'s point in `examples/dqn_cartpole_torch.py`'s Config:
# the fields it sets otherwise; the rest of that Config (Adam 1e-3,
# epsilon 0.1, tau 0.05 every 5, gamma 0.99, MLP (100, 50), seed 0) and
# its loop's squared loss and return deque of 20 are `bench.py`'s.
BENCH_POINT = dict(env_batch_size=4096, replay_capacity=512,
                   sample_batch_size=256)
# `bench.py:conv_bench` is `examples/dqn_pixels_torch.py`'s default
# Config (B=128, sample 256, mnih15 + fc 512 in bf16 over x/255, Adam
# 2.5e-4 eps 1.5e-4, epsilon 0.05, a hard target update every 500, Huber
# loss) at each of these rings per row.
CONV_CAPACITIES = (512, 2048)
# `bench.py:sac_live_probe`'s agent and replay in
# `examples/sac_halfcheetah_torch.py`'s Config, whose (256, 256) networks,
# Adam 3e-4 and reward scale 0.1 are the probe's already.
SAC_POINT = dict(env_batch_size=32, replay_capacity=4096,
                 sample_batch_size=256, train_steps_per_call=32,
                 utd_ratio=1.0, initial_collect_ticks=64)
SAC_MIN_TICKS = 1200

# The depths of `--smoke`, by function. On the CPU the pixel bench also
# takes `bench.py`'s smoke shapes (:202-226), `CONV_CPU_SMOKE`.
SMOKE = {
    "bench_point": dict(chunk=100, warmup_chunks=1, timed_chunks=2),
    "conv_bench": dict(chunk=10, timed_chunks=2),
    "host_atari_replay_probe": dict(capacity=100_000),
    "sac_live_probe": dict(seconds=0.0, max_ramp_runs=1),
}
CONV_CPU_SMOKE = dict(env_batch_size=8, sample_batch_size=16,
                      replay_capacity=64, pixels_size=20)


def card_line():
  """The card's name and power limit as ``nvidia-smi`` prints them."""
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True)
  return out.stdout.strip().splitlines()[0]


def card_fields(device):
  """{"name", "power_limit"} of `card_line()`; None on the CPU."""
  if device.type != "cuda":
    return None
  name, power_limit = (f.strip() for f in card_line().rsplit(",", 1))
  return {"name": name, "power_limit": power_limit}


def synchronize(device):
  import torch

  if device.type == "cuda":
    torch.cuda.synchronize(device)


def free_card():
  """Drop unreferenced tensors and return the card's cached blocks."""
  import torch

  gc.collect()
  torch.cuda.empty_cache()


@contextlib.contextmanager
def tf32_off():
  """TF32 off for matmul and cuDNN within; the caller's setting after."""
  import torch

  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def warm_up(loop, state, device, chunk, chunks):
  """`chunks` calls of ``loop.run(state, chunk)``, each ended by a
  synchronize; returns the state."""
  for _ in range(chunks):
    state, _ = loop.run(state, chunk)
    synchronize(device)
  return state


def run_timed(loop, state, device, chunk, chunks):
  """`chunks` timed calls of ``loop.run(state, chunk)``, each ended by a
  synchronize; on a card each runs under ``set_sync_debug_mode("error")``,
  so a sync inside the loop raises. Returns (state, the last chunk's
  losses, ms per iteration of each chunk)."""
  import torch

  on_card = device.type == "cuda"
  chunk_ms, losses = [], None
  for _ in range(chunks):
    t0 = time.perf_counter()
    if on_card:
      torch.cuda.set_sync_debug_mode("error")
    try:
      state, losses = loop.run(state, chunk)
    finally:
      if on_card:
        torch.cuda.set_sync_debug_mode(0)
    synchronize(device)
    chunk_ms.append((time.perf_counter() - t0) * 1e3 / chunk)
  return state, losses, chunk_ms


# -- the fused DQN-CartPole bench point (bench.py:386-447) -------------------


@tf32_off()
def bench_point(device="cuda", chunk=500, warmup_chunks=8, timed_chunks=4):
  """The bench point: init with 100 collect steps, `warmup_chunks` chunks
  of `chunk` iterations, then `timed_chunks` timed chunks. The warm-up also
  trains, so the run ends after 6,000 iterations, where the last-20 return
  is held to 195."""
  from agents_tpu_torch.utils.device import resolve_device
  from examples.dqn_cartpole_torch import Config, build_loop

  device = resolve_device(device)
  loop = build_loop(Config(**BENCH_POINT, device=str(device)))
  state = loop.init(seed=0, initial_collect_steps=100)
  state = warm_up(loop, state, device, chunk, warmup_chunks)
  state, _, chunk_ms = run_timed(loop, state, device, chunk, timed_chunks)
  iterations = chunk * timed_chunks
  wall_s = sum(chunk_ms) * chunk / 1e3
  B = loop.env.batch_size
  return {
      "env_steps_per_s": iterations * B / wall_s,
      "avg_return_last20": float(loop.results(state)["AverageReturn"]),
      "timed_iterations": iterations,
      "batch_size": B,
      "wall_s": wall_s,
      "chunk_ms_per_iteration": chunk_ms,
  }


# -- the mnih15 pixel bench (bench.py:147-294) -------------------------------


def conv_forward_flops(size, frames, num_actions, convs, fc):
  """Analytic FLOPs of one Q-network forward on one frame, as
  ``bench.py:236-251`` counts them: SAME padding, ceil(dim / stride)
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


def conv_iteration_flops(size, frames, num_actions, batch_rows, sample,
                         convs=MNIH15, fc=(512,)):
  """Model FLOPs of one fused iteration: the collect forward on the B
  rows; the train step's online forward, backward (about 2x forward) and
  target forward on the S windows (``bench.py:252-254``)."""
  fwd = conv_forward_flops(size, frames, num_actions, convs, fc)
  return fwd * (batch_rows + 4 * sample)


@tf32_off()
def conv_bench(max_length=2048, device="cuda", chunk=100, warmup_chunks=4,
               timed_chunks=4, **shapes):
  """The pixel bench point at `max_length` frames per row (2,048: 262k
  frames, 7.4 GB of uint8 on the card): 64 collect steps, `warmup_chunks`
  and `timed_chunks` chunks of `chunk` iterations. `shapes` (pixel Config
  fields) override the point's widths."""
  from agents_tpu_torch.utils.device import resolve_device
  from examples.dqn_pixels_torch import Config, build_loop

  device = resolve_device(device)
  loop = build_loop(Config(**{"replay_capacity": max_length, **shapes},
                           device=str(device)))
  pixels = loop.env.env
  B, SAMPLE = loop.env.batch_size, loop.sample_batch_size
  state = loop.init(seed=0, initial_collect_steps=64)
  state = warm_up(loop, state, device, chunk, warmup_chunks)
  state, _, chunk_ms = run_timed(loop, state, device, chunk, timed_chunks)
  ms = sum(chunk_ms) / len(chunk_ms)
  flops = conv_iteration_flops(pixels.size, pixels.frames,
                               pixels.num_actions, B, SAMPLE)
  card = card_fields(device)
  obs = state.replay_state.storage.observation
  return {
      "env_steps_per_s": B * 1e3 / ms,
      "iteration_ms": ms,
      "chunk_ms_per_iteration": chunk_ms,
      # A share of the card's peak: none off the card.
      "mfu": (flops / (ms / 1e3) / H100_PEAK_FLOPS_BF16) if card else None,
      "power_limit": card["power_limit"] if card else None,
      "replay_capacity_frames": B * loop.replay.capacity,
      "replay_hbm_gb": obs.numel() * obs.element_size() / 2**30,
      "model_gflop_per_iteration": flops / 1e9,
      "flops_note": "mfu: analytic model FLOPs (collect forward + train "
                    "forward, backward and target forward) over the H100 "
                    "SXM's dense bf16 peak",
      "batch_rows": B,
      "sample_batch": SAMPLE,
      "obs_shape": f"{pixels.size}x{pixels.size}x{pixels.frames} uint8",
      "dtype": "bfloat16 compute",
      "avg_return_last20": float(loop.results(state)["AverageReturn"]),
      "peak_flops_ref": "H100 SXM dense bf16 989e12 (NVIDIA data sheet, "
                        "700 W)",
  }


# -- the 1M-frame host replay (bench.py:297-383) -----------------------------


@tf32_off()
def host_atari_replay_probe(capacity=1_000_000, hashed_frames=100_000,
                            device="cuda"):
  """The mnih15 replay of 1M 84x84x4 uint8 frames in host RAM
  (`PyUniformReplayBuffer`; the hashed variant `PyHashedReplayBuffer` at
  `hashed_frames`): the fill rate in chunks of 1,024 frames, 40 random
  2-step samples at batch 256, 10 host-to-card copies of the sampled batch
  (pageable numpy memory, as the JAX probe's; ``pinned`` says so), and the
  cadence mnih15 needs (a batch-256 sample every 4 env frames).

  `checks`: the buffer holds every frame added; each sampled window is two
  consecutive frames of those added, in both buffers; the copy on `device`
  equals the batch; the hashed buffer keeps 1,024 unique frames; and, at
  equal capacities, both buffers give equal samples from equal seeds."""
  import numpy as np
  import torch

  from agents_tpu_torch.replay_buffers.py_uniform_replay import (
      PyHashedReplayBuffer, PyUniformReplayBuffer)
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import nest_utils
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(device)
  obs_spec = array_spec.ArraySpec((84, 84, 4), np.uint8)
  act_spec = array_spec.BoundedArraySpec((), np.int32, 0, 3)
  spec = tj.trajectory_spec(ts.time_step_spec(obs_spec), act_spec)

  buf = PyUniformReplayBuffer(spec, capacity, reuse_sample_buffers=True)
  CHUNK = 1024
  rng = np.random.RandomState(0)
  block = array_spec.map_spec_nest(
      lambda s: rng.randint(0, 255, (CHUNK,) + s.shape).astype(s.dtype)
      if s.dtype == np.uint8 else np.zeros((CHUNK,) + s.shape, s.dtype),
      spec)
  t0 = time.perf_counter()
  for _ in range(capacity // CHUNK):
    buf.add_batch(block)
  fill_s = time.perf_counter() - t0

  SAMPLES = 40
  t0 = time.perf_counter()
  for i in range(SAMPLES):
    batch = buf.sample(256, num_steps=2, rng=np.random.RandomState(i))
  sample_s = (time.perf_counter() - t0) / SAMPLES

  leaves = nest_utils.flatten(batch)
  batch_bytes = sum(x.nbytes for x in leaves)

  def copy_batch():
    return [torch.from_numpy(x).to(device) for x in leaves]

  copy_batch()
  synchronize(device)
  t0 = time.perf_counter()
  for _ in range(10):
    copied = copy_batch()
  synchronize(device)
  transfer_s = (time.perf_counter() - t0) / 10

  # The hashed (dedup) variant: per-frame content hashing bounds its add
  # rate; CHUNK distinct frames, repeated.
  hbuf = PyHashedReplayBuffer(spec, hashed_frames, reuse_sample_buffers=True)
  t0 = time.perf_counter()
  for _ in range(hashed_frames // CHUNK):
    hbuf.add_batch(block)
  hashed_fill_s = time.perf_counter() - t0
  filled = capacity // CHUNK * CHUNK
  hashed = hashed_frames // CHUNK * CHUNK

  # Frame k of either buffer is row k % CHUNK of the block.
  row_of = {block.observation[r].tobytes(): r for r in range(CHUNK)}

  def windows_stored(b):
    rows = [[row_of.get(frame.tobytes()) for frame in window]
            for window in b.observation]
    return all(first is not None and second == (first + 1) % CHUNK
               for first, second in rows)

  hashed_batch = hbuf.sample(256, num_steps=2, rng=np.random.RandomState(0))
  checks = {
      "frames_filled": len(buf) == filled,
      "sample_shape": batch.observation.shape == (256, 2, 84, 84, 4),
      "windows_stored": windows_stored(batch),
      "hashed_windows_stored": windows_stored(hashed_batch),
      "copy_equal": all(np.array_equal(c.cpu().numpy(), x)
                        for c, x in zip(copied, leaves)),
      "hashed_unique_observations": hbuf.num_unique_observations == CHUNK,
  }
  if capacity == hashed_frames:
    checks["hashed_samples_equal_uniform"] = all(
        np.array_equal(a, b) for a, b in zip(
            nest_utils.flatten(buf.sample(64, num_steps=2,
                                          rng=np.random.RandomState(99))),
            nest_utils.flatten(hbuf.sample(64, num_steps=2,
                                           rng=np.random.RandomState(99)))))
  resident = sum(x.nbytes for x in nest_utils.flatten(buf._storage))
  return {
      "capacity_frames": capacity,
      "frames_filled": len(buf),
      "resident_gb": resident / 2**30,
      "resident_bytes": resident,
      "fill_frames_per_s": filled / fill_s,
      "sample_batch256_ms": sample_s * 1e3,
      "sample_frames_per_s": 256 * 2 / sample_s,
      "batch_bytes": batch_bytes,
      "host_to_device_ms": transfer_s * 1e3,
      "host_to_device_gbps": batch_bytes / transfer_s / 1e9,
      "pinned": False,
      "hashed_frames": hashed,
      "hashed_add_frames_per_s": hashed / hashed_fill_s,
      "hashed_unique_observations": hbuf.num_unique_observations,
      "hashed_observation_bytes_stored": hbuf.observation_bytes_stored,
      "hashed_dedup_ratio": hashed / max(hbuf.num_unique_observations, 1),
      # mnih15 trains one batch-256 step per 4 env frames. On the card's
      # machine the sampled batch crosses PCIe from pageable host memory
      # to the H100 in the same process, so the with-transfer number is
      # this host path's own cadence; the host-only one leaves the copy
      # out.
      "mnih15_cadence_env_frames_per_s_host_only": 4.0 / sample_s,
      "mnih15_cadence_env_frames_per_s_with_transfer":
          4.0 / (sample_s + transfer_s),
      "checks": checks,
  }


# -- the live SAC probe (bench.py:57-144) ------------------------------------


def halfcheetah_specs():
  """HalfCheetah-v5's specs: observation (17,) float32 (unbounded),
  action (6,) float32 in [-1, 1]."""
  import numpy as np

  from agents_tpu_torch.specs import array_spec

  return (array_spec.ArraySpec((HALFCHEETAH_OBS,), np.float32, "observation"),
          array_spec.BoundedArraySpec((HALFCHEETAH_ACT,), np.float32, -1.0,
                                      1.0, "action"))


def random_halfcheetah(seed=0, **kwargs):
  """A seeded `RandomPyEnvironment` with HalfCheetah-v5's specs; by default
  1,000-step episodes, as HalfCheetah's time limit gives."""
  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment

  kwargs = {"episode_end_probability": 0.0, "max_duration": 1000, **kwargs}
  return RandomPyEnvironment(*halfcheetah_specs(), seed=seed, **kwargs)


def halfcheetah_envs():
  """(a factory of host HalfCheetahs, its name): HalfCheetah-v5 through
  `suite_gym` when gymnasium and MuJoCo import, else `random_halfcheetah`
  with a new seed each call."""
  if (importlib.util.find_spec("gymnasium") is not None
      and importlib.util.find_spec("mujoco") is not None):
    from agents_tpu_torch.environments import suite_gym

    return (lambda: suite_gym.load("HalfCheetah-v5")), "HalfCheetah-v5"
  seeds = itertools.count()
  return (lambda: random_halfcheetah(next(seeds)),
          "random_halfcheetah (HalfCheetah-v5 specs, 1,000-step episodes)")


def sac_loop(device, env_factory):
  """``bench.py:79-96``'s loop: `examples/sac_halfcheetah_torch.py`'s SAC
  agent and replay at `SAC_POINT`, and an `AsyncHostDeviceTrainLoop` that
  counts env steps only, over `SAC_POINT`'s B host envs from
  `env_factory`."""
  from agents_tpu_torch.environments.batched_py_environment import (
      BatchedPyEnvironment)
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.train import AsyncHostDeviceTrainLoop
  from examples.sac_halfcheetah_torch import Config, build_agent

  cfg = Config(**SAC_POINT, device=str(device))
  B = cfg.env_batch_size
  env = BatchedPyEnvironment([env_factory() for _ in range(B)])
  agent, replay = build_agent(cfg, env, device)
  return AsyncHostDeviceTrainLoop(
      env, agent, replay, sample_batch_size=cfg.sample_batch_size,
      train_steps_per_call=cfg.train_steps_per_call,
      utd_ratio=cfg.utd_ratio,
      min_replay_frames=cfg.initial_collect_ticks * B,
      py_metrics=[py_metrics.EnvironmentSteps()], device=device)


@tf32_off()
def sac_live_probe(seconds=90.0, env_factory=None, max_ramp_runs=6,
                   device="cuda"):
  """SAC at the haarnoja18 point (`sac_loop`) over 32 host envs: up to
  `max_ramp_runs` runs of 256 ticks until the realized UTD reaches 0.8,
  then ``max(1200, seconds * 650 / B)`` timed ticks; env-steps/s,
  train-steps/s, the realized UTD and the collector's tick with and
  without a train call in flight. `env_factory` builds one host env
  (`halfcheetah_envs()`'s unless given). `probe_ok` is the UTD >= 0.8
  guard, reported, not raised; `checks` hold what must be true whatever
  the UTD."""
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(device)
  if env_factory is None:
    env_factory, env_name = halfcheetah_envs()
  else:
    env_name = getattr(env_factory, "__name__", "env_factory")
  loop = sac_loop(device, env_factory)
  B, K = loop.env.batch_size, loop.train_steps_per_call
  min_frames = loop.min_replay_frames
  try:
    def utd_of(out, ticks):
      # Train steps start only once the replay holds min_frames; normalize
      # by the trainable part of the window.
      trainable = max(ticks * B - min_frames, 1)
      return int(out["train_steps"]) / trainable

    # Pre-ramp: repeat short runs until the trainer keeps up, so that the
    # timed window covers the train path.
    ramp_utd, ramp_runs, ramps = 0.0, 0, []
    for ramp_runs in range(1, max_ramp_runs + 1):
      out = loop.run(total_env_batch_steps=256, seed=0,
                     initial_random_steps=32)
      ramps.append(out)
      ramp_utd = utd_of(out, 256)
      if ramp_utd >= 0.8:
        break

    ticks = max(SAC_MIN_TICKS, int(seconds * 650 / B))
    t0 = time.perf_counter()
    out = loop.run(total_env_batch_steps=ticks, seed=0,
                   initial_random_steps=32)
    dt = time.perf_counter() - t0
  finally:
    loop.env.close()
  train_steps = int(out["train_steps"])
  utd = utd_of(out, ticks)
  checks = {
      "trainer_drained": all(r["trainer_drained"] for r in ramps + [out]),
      "env_steps_exact": out["env_steps"] == ticks * B,
      "train_steps_within_utd":
          train_steps <= loop.utd_ratio * out["env_steps"] + K,
      "trainer_trained": train_steps > 0 and ramps[0]["train_steps"] > 0,
      "loss_finite": math.isfinite(out["last_loss"]),
  }
  return {
      "env": env_name,
      "env_steps_per_s": ticks * B / dt,
      "train_steps_per_s": train_steps / dt,
      # Realized update-to-data over the trainable window; the haarnoja18
      # cadence is 1.0, and bench.py's guard asks for 0.8.
      "utd_realized": utd,
      "probe_ok": bool(utd >= 0.8),
      "ramp_runs": ramp_runs,
      "ramp_utd": ramp_utd,
      "ticks": ticks,
      "window_s": dt,
      "env_steps": out["env_steps"],
      "train_steps": train_steps,
      "last_loss": out["last_loss"],
      "tick_ms_trainer_idle": out["tick_ms_trainer_idle"],
      "tick_ms_trainer_busy": out["tick_ms_trainer_busy"],
      "ticks_trainer_idle": out["ticks_trainer_idle"],
      "ticks_trainer_busy": out["ticks_trainer_busy"],
      "ref_cpu_env_steps_per_s": TF_AGENTS_SAC_CPU_ENV_STEPS_PER_S,
      "vs_baseline": ticks * B / dt / TF_AGENTS_SAC_CPU_ENV_STEPS_PER_S,
      "note": "pre-ramped until the trainer sustains UTD 0.8 or the ramp "
              "ran out; over random_halfcheetah the env step is far cheaper "
              "than MuJoCo's, so env-steps/s and vs_baseline are no "
              "HalfCheetah rate",
      "checks": checks,
  }


# -- the line ------------------------------------------------------------------


def smoke_depths(device):
  """`SMOKE`'s depths on `device`: on the CPU the pixel bench also takes
  `CONV_CPU_SMOKE`'s shapes."""
  depths = {name: dict(kwargs) for name, kwargs in SMOKE.items()}
  if device.type == "cpu":
    depths["conv_bench"].update(CONV_CPU_SMOKE)
  return depths


def smoke_cuts(depths):
  """`depths` as `detail.reduced` lists them, each value beside the full
  run's."""
  from examples.dqn_pixels_torch import Config

  full_widths = {**dataclasses.asdict(Config()),
                 "replay_capacity": CONV_CAPACITIES}
  cuts = []
  for name, kwargs in depths.items():
    full = {k: p.default for k, p in
            inspect.signature(globals()[name]).parameters.items()}
    cuts.append(f"{name}: " + ", ".join(
        f"{k} {v!r} (full: {full.get(k, full_widths.get(k))!r})"
        for k, v in kwargs.items()))
  return cuts


def main(argv=None):
  import torch

  from agents_tpu_torch.utils.device import resolve_device

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--smoke", action="store_true",
                      help="every function at a small depth")
  args = parser.parse_args(argv)
  device = resolve_device(args.device)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  depth = smoke_depths(device) if args.smoke else {}

  point = bench_point(device, **depth.get("bench_point", {}))
  conv = {}
  for cap in CONV_CAPACITIES:
    conv[f"capacity_{128 * cap // 1000}k_frames"] = conv_bench(
        **{"max_length": cap, "device": device,
           **depth.get("conv_bench", {})})
    free_card()
  host_replay = host_atari_replay_probe(
      device=device, **depth.get("host_atari_replay_probe", {}))
  sac_live = sac_live_probe(device=device, **depth.get("sac_live_probe", {}))
  for name, result in (("host_atari_replay_probe", host_replay),
                       ("sac_live_probe", sac_live)):
    failed = [check for check, ok in result["checks"].items() if not ok]
    if failed:
      raise RuntimeError(f"{name}: checks failed: {failed}")

  solved = point["avg_return_last20"] >= SOLVED_RETURN
  value = point["env_steps_per_s"] if solved else 0.0
  print(json.dumps({
      "metric": "dqn_cartpole_fused_env_steps_per_s",
      "value": value,
      "unit": "env-steps/s per card (0 if return < 195)",
      "vs_baseline": value / TF_AGENTS_CPU_ENV_STEPS_PER_S,
      "detail": {
          "avg_return_last20": point["avg_return_last20"],
          "timed_iterations": point["timed_iterations"],
          "batch_size": point["batch_size"],
          "train_steps_per_env_batch_step": 1,
          "wall_s": point["wall_s"],
          "chunk_ms_per_iteration": point["chunk_ms_per_iteration"],
          "atari_conv_mnih15": conv,
          "atari_host_replay_1m": host_replay,
          "sac_halfcheetah_live_throughput": sac_live,
          "card": card_fields(device),
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32},
          "reduced": smoke_cuts(depth) if args.smoke else [],
      },
  }), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
