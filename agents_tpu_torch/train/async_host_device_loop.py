"""Asynchronous host-device training: a collector thread and a trainer
thread.

Port of ``agents_tpu/train/async_host_device_loop.py``, the single-process
actor-learner. The collector (the thread that calls `run`) inserts the
previous transition into the device replay, acts with the collect policy
and steps the host env; the trainer thread runs `train_steps_per_call`
gradient steps per call on replay samples, throttled to `utd_ratio`
train steps per env step once the replay holds `min_replay_frames`.

The JAX loop shares state race-free by swapping references to immutable
device arrays. Here the parameters, the optimizer state and the replay
ring are updated in place, so the loop rebuilds what immutability gave:

  - A whole-call parameter snapshot. The collector acts from its own copy
    of the collect policy's parameters. After each train call the trainer
    copies the live parameters into it under `_params_lock`, and the
    collector holds the lock while it dispatches its action, so it acts
    from the parameters as one completed train call left them, never a mix
    of two calls.
  - No torn replay windows. The collector holds `_replay_lock` around
    `add_batch`, and the trainer around the dispatch of each `sample`,
    reading the replay state of that moment. Both threads dispatch on one
    CUDA stream, so a sample's gather runs before any later insert's
    writes and sees the ring as of its dispatch: a window never mixes
    frames from either side of an insert. (The JAX trainer samples the
    replay state it took at the start of its call instead.)
  - One draw source per thread: the collector's (`collect_draws`, the
    collect policy's noise) and the trainer's (`trainer_draws`, the replay
    samples); the agent state's own source (its train-step noise) is the
    trainer's alone. A checkpoint holds all three.

`run` is re-entrant: each call is a fresh session with its own counters
and metric state, and the networks start again from the weights they were
built with. A checkpoint pauses the trainer with a generation-stamped
request and waits for its acknowledgement, so agent state, train steps and
trainer draws are saved as one consistent whole; a final checkpoint
follows the trainer's drain. Stopping is bounded: the trainer checks the
stop flag between calls, `run` joins it with a timeout and reports
`trainer_drained`. An exception in the trainer is raised from `run`.

Both threads dispatch eager PyTorch ops and so contend for the GIL: the
collector's tick is slower while the trainer runs. `run` reports the
collector's median tick time with and without a train call in flight.
"""
from __future__ import annotations

import contextlib
import copy
import statistics
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.metrics import py_metrics as py_metrics_lib
from agents_tpu_torch.policies.jitted_py_policy import to_device, to_numpy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.train.checkpointer import capture, restore_into
from agents_tpu_torch.train.host_device_loop import zero_action
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import check_devices, resolve_device
from agents_tpu_torch.utils.draws import Draws

TRAINER_JOIN_TIMEOUT_S = 10.0
PAUSE_TIMEOUT_S = 120.0


def param_tensors(params):
  """Every tensor of a parameter nest, modules' parameters and buffers
  included, in a fixed order."""
  out = []
  for leaf in nest_utils.flatten(params):
    if isinstance(leaf, nn.Module):
      out.extend(leaf.state_dict(keep_vars=True).values())
    elif isinstance(leaf, torch.Tensor):
      out.append(leaf)
  return out


class AsyncHostDeviceTrainLoop:
  """Args:
    env: a batched host env.
    agent: an off-policy Agent of the port.
    replay: UniformReplay with batch_size == env.batch_size.
    sample_batch_size: replay sample per gradient step.
    train_steps_per_call: gradient steps per trainer call.
    utd_ratio: train steps per env step the trainer may not exceed (None:
      no throttle).
    min_replay_frames: env steps before the trainer starts.
    py_metrics: numpy metrics called with each host frame.
    device: "cuda" unless the caller asks for "cpu"; agent and replay must
      live there too.
  """

  def __init__(self, env, agent, replay, sample_batch_size: int = 256,
               train_steps_per_call: int = 8,
               utd_ratio: Optional[float] = None,
               min_replay_frames: int = 1000, py_metrics=(), device="cuda"):
    self.device = resolve_device(device)
    check_devices(self.device, agent=agent, replay=replay)
    self.env = env
    self.agent = agent
    self.replay = replay
    self.sample_batch_size = sample_batch_size
    self.train_steps_per_call = train_steps_per_call
    self.utd_ratio = utd_ratio
    self.min_replay_frames = min_replay_frames
    self.py_metrics = list(py_metrics)

    self._replay_lock = threading.Lock()
    self._params_lock = threading.Lock()
    self._initial_agent = None
    self._agent_state = None
    self._replay_state = None
    self._collect_params = None
    self._collect_draws = None
    self._trainer_draws = None
    self._stream = None
    self._env_steps = 0
    self._train_steps = 0
    self._train_calls = 0
    self._in_call = False
    self._session_start_steps = 0
    self._last_loss = float("nan")
    self._stop = threading.Event()
    self._pause = threading.Event()
    self._pause_gen = 0
    self._ack_gen = -1
    self._trainer_thread: Optional[threading.Thread] = None
    self._trainer_error: Optional[BaseException] = None

  # -- trainer thread ----------------------------------------------------------
  def _sample(self):
    """One replay sample of the ring as it stands (under the replay
    lock)."""
    with self._replay_lock:
      experience, _ = self.replay.sample(
          self._replay_state, self._trainer_draws, self.sample_batch_size,
          num_steps=self.agent.train_sequence_length)
    return experience

  def _train_call(self):
    """`train_steps_per_call` gradient steps; returns the last loss."""
    agent_state, loss = self._agent_state, None
    for _ in range(self.train_steps_per_call):
      agent_state, loss_info = self.agent.train(agent_state, self._sample())
      loss = loss_info.loss
    self._agent_state = agent_state
    return loss

  def _live_params(self):
    return self.agent.collect_policy_params(self._agent_state)

  def _publish(self):
    """Copy the live collect parameters into the collector's snapshot."""
    with self._params_lock, torch.no_grad():
      for dst, src in zip(param_tensors(self._collect_params),
                          param_tensors(self._live_params()), strict=True):
        dst.copy_(src)

  def _acting_params(self):
    """The parameters the collector acts from (hold `_params_lock`)."""
    return self._collect_params

  def _trainer_loop(self):
    stream = (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext())
    try:
      with stream:
        calls, loss = 0, None
        while not self._stop.is_set():
          if self._pause.is_set():
            self._ack_gen = self._pause_gen
            time.sleep(0.005)
            continue
          if self._env_steps < self.min_replay_frames:
            time.sleep(0.01)
            continue
          if self.utd_ratio is not None and \
              self._train_steps >= self.utd_ratio * self._env_steps:
            time.sleep(0.001)
            continue
          self._in_call = True
          loss = self._train_call()
          self._publish()
          self._in_call = False
          self._train_steps += self.train_steps_per_call
          self._train_calls += 1
          calls += 1
          # Read the loss back every 16 calls only: a read is a host sync.
          if calls % 16 == 0:
            self._last_loss = float(loss)
        if loss is not None:
          self._last_loss = float(loss)
    except Exception as e:  # pylint: disable=broad-except
      # Recorded for `run` to raise in the caller's thread.
      self._trainer_error = e
    finally:
      self._in_call = False

  # -- checkpointing ---------------------------------------------------------
  def _checkpoint_state(self, tick: int):
    return {
        "agent_state": self._agent_state,
        "replay_state": self._replay_state,
        "collect_draws": self._collect_draws,
        "trainer_draws": self._trainer_draws,
        "counters": {"tick": tick, "train_steps": self._train_steps},
        "metrics": py_metrics_lib.fixed_shape_states(self.py_metrics),
    }

  def _pause_trainer(self):
    """Ask the trainer to pause and wait for its acknowledgement of this
    request (or its end)."""
    self._pause_gen += 1
    gen = self._pause_gen
    self._pause.set()
    deadline = time.time() + PAUSE_TIMEOUT_S
    while time.time() < deadline:
      if self._ack_gen >= gen:
        break
      if self._trainer_thread is None or \
          not self._trainer_thread.is_alive():
        break
      time.sleep(0.005)

  def _save_checkpoint(self, checkpointer, tick: int):
    """Pause the trainer, save agent, replay, draws, counters and metric
    states as one checkpoint, resume."""
    self._pause_trainer()
    try:
      checkpointer.save(tick, self._checkpoint_state(tick))
      checkpointer.wait()
    finally:
      self._pause.clear()

  # -- per-run state -----------------------------------------------------------
  def _fresh_agent_state(self):
    """A new agent state over the networks as they were built (the first
    run keeps a copy of them)."""
    state = self.agent.init()
    if self._initial_agent is None:
      # A copy: on the CPU the capture's tensors share the parameters'.
      self._initial_agent = copy.deepcopy(capture(state))
      return state
    return restore_into(state, self._initial_agent)

  def template_state(self, seed: int = 0):
    """A fresh state of the checkpoint's shape (to restore into)."""
    self._agent_state = self._fresh_agent_state()
    self._replay_state = self.replay.init()
    self._collect_draws = Draws(seed + 1, self.device)
    self._trainer_draws = Draws(seed + 2, self.device)
    self._train_steps = 0
    for m in self.py_metrics:
      if hasattr(m, "reset"):
        m.reset()
    return self._checkpoint_state(0)

  def published_params(self):
    """A copy of the collector's parameter snapshot (taken under its lock):
    parameters of one completed train call, safe to evaluate with while
    the trainer runs."""
    with self._params_lock:
      return copy.deepcopy(self._collect_params)

  # -- main --------------------------------------------------------------------
  def run(self, total_env_batch_steps: int, seed: int = 0,
          initial_random_steps: int = 100, progress_fn=None,
          progress_every: int = 1000, checkpointer=None,
          checkpoint_interval_ticks: int = 0, resume: bool = False):
    B = self.env.batch_size
    rng = np.random.RandomState(seed)
    # The previous session's trainer must be dead before the stop flag is
    # cleared, or it would keep training beside the new one.
    if self._trainer_thread is not None and self._trainer_thread.is_alive():
      self._stop.set()
      self._trainer_thread.join()
    self._stop.clear()
    self._pause.clear()
    self._ack_gen = self._pause_gen - 1
    self._trainer_error = None
    template = self.template_state(seed)
    self._env_steps = 0
    self._train_calls = 0
    self._last_loss = float("nan")

    start_tick = 0
    if checkpointer is not None and resume and \
        checkpointer.latest_step() is not None:
      st = checkpointer.restore(template)
      self._agent_state = st["agent_state"]
      self._replay_state = st["replay_state"]
      self._collect_draws = st["collect_draws"]
      self._trainer_draws = st["trainer_draws"]
      start_tick = int(st["counters"]["tick"])
      self._env_steps = start_tick * B
      self._train_steps = int(st["counters"]["train_steps"])
      py_metrics_lib.load_fixed_shape_states(self.py_metrics, st["metrics"])
    self._session_start_steps = self._env_steps
    self._collect_params = copy.deepcopy(self._live_params())
    self._stream = (torch.cuda.current_stream(self.device)
                    if self.device.type == "cuda" else None)

    time_step = self.env.reset()
    prev_time_step, prev_time_step_dev = time_step, None
    prev_action = zero_action(self.agent.action_spec, B)
    prev_action_dev = None
    ticks_idle, ticks_busy = [], []

    trainer = threading.Thread(target=self._trainer_loop, daemon=True)
    self._trainer_thread = trainer
    trainer.start()
    t0 = time.time()
    try:
      for tick in range(start_tick, total_env_batch_steps):
        t_tick, calls_before = time.perf_counter(), self._train_calls
        busy_before = self._in_call
        time_step_dev = to_device(time_step, self.device)
        # The first tick of this session inserts nothing: after a resume
        # too, the previous transition would be a fresh reset with a zero
        # action, a fabricated frame.
        if tick > start_tick:
          frame = tj.from_transition(prev_time_step_dev,
                                     ps.PolicyStep(action=prev_action_dev),
                                     time_step_dev)
          with self._replay_lock:
            self._replay_state = self.replay.add_batch(self._replay_state,
                                                       frame)
        if tick < initial_random_steps:
          action = array_spec.np_sample_spec_nest(
              self.agent.action_spec, rng, outer_dims=(B,))
          action_dev = to_device(action, self.device)
        else:
          with self._params_lock, torch.no_grad():
            action_dev = self.agent.collect_policy.action(
                self._acting_params(), time_step_dev, (),
                self._collect_draws).action
          action = to_numpy(action_dev)
        next_time_step = self.env.step(action)
        if self.py_metrics:
          host_frame = tj.from_transition(
              time_step, ps.PolicyStep(action=action), next_time_step)
          for m in self.py_metrics:
            m(host_frame)
        prev_time_step, prev_time_step_dev = time_step, time_step_dev
        prev_action, prev_action_dev = action, action_dev
        time_step = next_time_step
        self._env_steps = (tick + 1) * B
        busy = (busy_before or self._in_call
                or self._train_calls != calls_before)
        (ticks_busy if busy else ticks_idle).append(
            time.perf_counter() - t_tick)
        if self._trainer_error is not None:
          break
        if progress_fn and (tick + 1) % progress_every == 0:
          progress_fn(self)
        if checkpointer is not None and checkpoint_interval_ticks and \
            (tick + 1) % checkpoint_interval_ticks == 0 and \
            (tick + 1) < total_env_batch_steps:
          self._save_checkpoint(checkpointer, tick + 1)
    finally:
      self._stop.set()
      trainer.join(timeout=TRAINER_JOIN_TIMEOUT_S)
    if self._trainer_error is not None:
      raise RuntimeError("the trainer thread failed") from \
          self._trainer_error
    if checkpointer is not None and checkpoint_interval_ticks and \
        total_env_batch_steps > start_tick:
      # The final state, after the trainer's drain: a later run with a
      # higher target resumes from here.
      self._save_checkpoint(checkpointer, total_env_batch_steps)
    median_ms = lambda xs: (statistics.median(xs) * 1e3  # noqa: E731
                            if xs else float("nan"))
    return {
        "env_steps": self._env_steps,
        "train_steps": self._train_steps,
        "wall_s": time.time() - t0,
        "last_loss": self._last_loss,
        "trainer_drained": not trainer.is_alive(),
        "metrics": {m.name: m.result() for m in self.py_metrics},
        "agent_state": self._agent_state,
        "tick_ms_trainer_idle": median_ms(ticks_idle),
        "tick_ms_trainer_busy": median_ms(ticks_busy),
        "ticks_trainer_idle": len(ticks_idle),
        "ticks_trainer_busy": len(ticks_busy),
    }
