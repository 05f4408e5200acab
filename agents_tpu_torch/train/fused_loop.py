"""The fused training iteration on the card.

Port of ``agents_tpu/train/fused_loop.py`` (uniform replay, one device):
one `iteration` does

    collect (policy + env, `collect_steps_per_iteration` lockstep steps)
    -> replay insert -> replay sample -> agent.train -> metric updates

and makes no host sync: no `.item()`, no boolean-mask indexing, no
data-dependent shapes, no host-to-device copies. The replay count and the
train step are host ints, so every branch the host takes is known without
asking the card. `run(n)` returns the n losses as one device tensor.

The JAX package compiles the iteration into one program; here it runs
eagerly, op by op, and the replay storage, parameters and optimizer state
are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from agents_tpu_torch.drivers.torch_driver import DriverState, TorchDriver
from agents_tpu_torch.eval import metric_utils
from agents_tpu_torch.metrics import torch_metrics
from agents_tpu_torch.replay_buffers.uniform_replay import UniformReplay
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device
from agents_tpu_torch.utils.draws import as_draws


@dataclasses.dataclass(frozen=True)
class LoopState:
  driver_state: DriverState
  replay_state: Any
  agent_state: Any
  metric_states: Any
  draws: Any


class FusedTrainLoop:
  """collect -> insert -> sample -> train, one iteration at a time.

  Args:
    env: BatchedTorchEnv.
    agent: an Agent (collect_policy drives collection).
    replay: UniformReplay storing Trajectory frames.
    metrics: metrics updated during collection.
    collect_steps_per_iteration: driver steps per iteration.
    sample_batch_size: replay sample size for training.
    train_steps_per_iteration: gradient steps per iteration.
    device: "cuda" unless the caller asks for "cpu"; env, agent and replay
      must live there too.
  """

  def __init__(self, env, agent, replay: UniformReplay, metrics=(),
               collect_steps_per_iteration: int = 1,
               sample_batch_size: int = 64,
               train_steps_per_iteration: int = 1, device="cuda"):
    self.device = resolve_device(device)
    for name, part in (("env", env), ("agent", agent), ("replay", replay)):
      if part.device.type != self.device.type:
        raise ValueError(
            f"{name} lives on {part.device}, the loop on {self.device}")
    self.env = env
    self.agent = agent
    self.replay = replay
    self.metrics = tuple(metrics)
    self.collect_steps = collect_steps_per_iteration
    self.sample_batch_size = sample_batch_size
    self.train_steps = train_steps_per_iteration
    observers = [self.replay.add_batch] + [m.update for m in self.metrics]
    self.driver = TorchDriver(env, agent.collect_policy, observers=observers)

  def init(self, seed: int = 0, initial_collect_steps: int = 0,
           draws=None) -> LoopState:
    """Fresh state. Draws come from `draws`, or from a generator on the
    device seeded with `seed`."""
    draws = draws if draws is not None else as_draws(seed, self.device)
    state = LoopState(
        agent_state=self.agent.init(),
        driver_state=self.driver.init(draws),
        replay_state=self.replay.init(),
        metric_states=tuple(m.init(self.env.batch_size, self.device)
                            for m in self.metrics),
        draws=draws)
    if initial_collect_steps:
      state = self.initial_collect(state, initial_collect_steps)
    return state

  def _collect(self, state: LoopState, num_steps: int) -> LoopState:
    params = self.agent.collect_policy_params(state.agent_state)
    obs_states = (state.replay_state,) + tuple(state.metric_states)
    driver_state, obs_states = self.driver.run(
        params, state.driver_state, obs_states, state.draws, num_steps)
    return dataclasses.replace(state, driver_state=driver_state,
                               replay_state=obs_states[0],
                               metric_states=tuple(obs_states[1:]))

  def initial_collect(self, state: LoopState, num_steps: int) -> LoopState:
    """Seed replay with the collect policy."""
    return self._collect(state, num_steps)

  def iteration(self, state: LoopState) -> Tuple[LoopState, LossInfo]:
    state = self._collect(state, self.collect_steps)
    agent_state = state.agent_state
    for _ in range(self.train_steps):
      experience, _ = self.replay.sample(
          state.replay_state, state.draws, self.sample_batch_size,
          num_steps=self.agent.train_sequence_length)
      agent_state, loss_info = self.agent.train(agent_state, experience)
    return dataclasses.replace(state, agent_state=agent_state), loss_info

  def run(self, state: LoopState, num_iterations: int):
    """`num_iterations` iterations; returns (state, losses [n] on device)."""
    state, infos = self.run_with_info(state, num_iterations)
    return state, infos.loss

  def run_with_info(self, state: LoopState, num_iterations: int):
    """Like `run` but returns the stacked LossInfo (loss and extras)."""
    infos = []
    for _ in range(num_iterations):
      state, info = self.iteration(state)
      infos.append(info)
    return state, nest_utils.stack_nested_tensors(infos)

  def results(self, state: LoopState):
    return {m.name: m.result(ms)
            for m, ms in zip(self.metrics, state.metric_states)}

  def evaluate(self, state: LoopState, seed_or_draws=0,
               num_episodes: int = 10, max_steps: int = 10_000,
               eval_metrics=None):
    """Greedy-policy eval over exactly `num_episodes` episodes on a fresh
    batch of env rows. Returns {metric_name: device scalar}; warns when
    `max_steps` ran out first."""
    metrics = tuple(eval_metrics) if eval_metrics else (
        torch_metrics.AverageReturnMetric(max(num_episodes, 10)),
        torch_metrics.AverageEpisodeLengthMetric(max(num_episodes, 10)),
        torch_metrics.NumberOfEpisodes())
    out = metric_utils.evaluate_torch_env_episodes(
        self.env, self.agent.policy,
        self.agent.policy_params(state.agent_state),
        as_draws(seed_or_draws, self.device), num_episodes, max_steps,
        metrics)
    return {m.name: out[m.name] for m in metrics}
