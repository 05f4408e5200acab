"""Host environments feeding the learner on the card, synchronously.

Port of ``agents_tpu/train/host_device_loop.py``: the host steps the C/C++
simulators (a batched host env), the replay and the learner live on the
device. Each tick of `run`:
  1. inserts the previous transition into the device replay,
  2. acts with the collect policy on the fresh observations,
  3. runs `train_steps_per_tick` gradient steps sampled from replay,
  4. reads the action back (the tick's one host sync) and steps the env.
The JAX package compiles 1-3 into one program; here they are dispatched
eagerly, op by op. The host-to-device copies of the time step and action
are ``non_blocking`` and each is made once: the copy made for a time step
or action in one tick serves as the previous one in the next. The replay
count and train step are host ints, as in the fused loop.

The very first tick of `collect` inserts nothing: there is no previous
transition yet, and a frame (reset, zero action, reset) would plant a
fabricated FIRST -> FIRST transition in the sampling window. Random
collect draws host actions from a `np.random.RandomState` in the JAX
package's order and makes no policy call.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Tuple

import numpy as np
import torch

from agents_tpu_torch.policies.jitted_py_policy import to_device, to_numpy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils.device import check_devices, resolve_device
from agents_tpu_torch.utils.draws import Draws

SPLIT_KEYS = ("device_call_s", "action_read_s", "env_step_s")


@dataclasses.dataclass(frozen=True)
class DeviceState:
  replay_state: Any
  agent_state: Any
  draws: Any


def zero_action(action_spec, batch_size):
  """A numpy zero action nest of `batch_size` rows."""
  return array_spec.map_spec_nest(
      lambda s: np.zeros((batch_size,) + s.shape, s.dtype), action_spec)


class HostDeviceTrainLoop:
  """Args:
    env: a batched host env (BatchedPyEnvironment, ParallelPyEnvironment).
    agent: an Agent of the port.
    replay: UniformReplay with batch_size == env.batch_size.
    train_steps_per_tick: gradient steps per tick (the update-to-data
      ratio is train_steps_per_tick / env.batch_size).
    sample_batch_size: replay sample per gradient step.
    py_metrics: numpy metrics called with each host frame.
    device: "cuda" unless the caller asks for "cpu"; agent and replay must
      live there too.

  `split` accumulates the host seconds of each tick's device dispatch,
  action read and env step (with the metrics) over the ticks so far.
  """

  def __init__(self, env, agent, replay, train_steps_per_tick: int = 1,
               sample_batch_size: int = 256, py_metrics=(), device="cuda"):
    self.device = resolve_device(device)
    check_devices(self.device, agent=agent, replay=replay)
    self.env = env
    self.agent = agent
    self.replay = replay
    self.train_steps_per_tick = train_steps_per_tick
    self.sample_batch_size = sample_batch_size
    self.py_metrics = list(py_metrics)
    self.split = dict.fromkeys(SPLIT_KEYS, 0.0)
    self._copies = ()

  def init(self, seed: int = 0, draws=None) -> Tuple[DeviceState, Any]:
    """(fresh device state, the env's first time step). The collect
    actions and replay samples draw from `draws`, or from
    ``Draws(seed + 1, device)``."""
    dev = DeviceState(
        replay_state=self.replay.init(), agent_state=self.agent.init(),
        draws=draws if draws is not None else Draws(seed + 1, self.device))
    self._copies = ()
    return dev, self.env.reset()

  # -- device work -----------------------------------------------------------
  def _device(self, host):
    """`host` on the device: the copy made for it in the last tick when
    there is one."""
    for h, d in self._copies:
      if h is host:
        return d
    return to_device(host, self.device)

  def _insert(self, dev: DeviceState, prev_time_step, prev_action,
              time_step_dev) -> DeviceState:
    frame = tj.from_transition(
        self._device(prev_time_step),
        ps.PolicyStep(action=self._device(prev_action)), time_step_dev)
    return dataclasses.replace(
        dev, replay_state=self.replay.add_batch(dev.replay_state, frame))

  @torch.no_grad()
  def _act(self, dev: DeviceState, time_step_dev):
    params = self.agent.collect_policy_params(dev.agent_state)
    return self.agent.collect_policy.action(params, time_step_dev, (),
                                            dev.draws).action

  def _train(self, dev: DeviceState):
    agent_state, loss = dev.agent_state, None
    for _ in range(self.train_steps_per_tick):
      experience, _ = self.replay.sample(
          dev.replay_state, dev.draws, self.sample_batch_size,
          num_steps=self.agent.train_sequence_length)
      agent_state, loss_info = self.agent.train(agent_state, experience)
      loss = loss_info.loss
    return dataclasses.replace(dev, agent_state=agent_state), loss

  # -- host loop -------------------------------------------------------------
  def _observe(self, time_step, action, next_time_step):
    if not self.py_metrics:
      return
    frame = tj.from_transition(time_step, ps.PolicyStep(action=action),
                               next_time_step)
    for m in self.py_metrics:
      m(frame)

  def _tick(self, dev, time_step, prev_time_step, prev_action, insert: bool,
            act: bool, train: bool, rng=None):
    """One tick; returns (dev, action, next time step, loss)."""
    t0 = time.perf_counter()
    time_step_dev = to_device(time_step, self.device)
    if insert:
      dev = self._insert(dev, prev_time_step, prev_action, time_step_dev)
    action_dev = self._act(dev, time_step_dev) if act else None
    loss = None
    if train:
      dev, loss = self._train(dev)
    t1 = time.perf_counter()
    if act:
      action = to_numpy(action_dev)
    else:
      action = array_spec.np_sample_spec_nest(
          self.agent.action_spec, rng, outer_dims=(self.env.batch_size,))
    t2 = time.perf_counter()
    next_time_step = self.env.step(action)
    self._observe(time_step, action, next_time_step)
    t3 = time.perf_counter()
    for key, seconds in zip(SPLIT_KEYS, (t1 - t0, t2 - t1, t3 - t2)):
      self.split[key] += seconds
    self._copies = ((time_step, time_step_dev),) + (
        ((action, action_dev),) if act else ())
    return dev, action, next_time_step, loss

  def collect(self, dev: DeviceState, time_step, num_ticks: int,
              random: bool = True, seed: int = 0):
    """Initial collection: host random actions from
    ``RandomState(seed)`` (no policy call), or the collect policy's.
    Returns (dev, time_step, prev_time_step, prev_action)."""
    rng = np.random.RandomState(seed)
    prev_action = zero_action(self.agent.action_spec, self.env.batch_size)
    prev_time_step = time_step
    for i in range(num_ticks):
      dev, action, next_time_step, _ = self._tick(
          dev, time_step, prev_time_step, prev_action, insert=i > 0,
          act=not random, train=False, rng=rng)
      prev_time_step, prev_action = time_step, action
      time_step = next_time_step
    return dev, time_step, prev_time_step, prev_action

  def run(self, dev: DeviceState, time_step, prev_time_step, prev_action,
          num_ticks: int):
    """`num_ticks` ticks of insert, act, train and env step. Returns (dev,
    time_step, prev_time_step, prev_action, the last tick's loss)."""
    loss = None
    for _ in range(num_ticks):
      dev, action, next_time_step, loss = self._tick(
          dev, time_step, prev_time_step, prev_action, insert=True,
          act=True, train=True)
      prev_time_step, prev_action = time_step, action
      time_step = next_time_step
    last_loss = float(loss) if loss is not None else float("nan")
    return dev, time_step, prev_time_step, prev_action, last_loss

  def metric_results(self):
    return {m.name: m.result() for m in self.py_metrics}
