"""The fused training iteration on the card.

Port of ``agents_tpu/train/fused_loop.py`` (one device): one `iteration`
does

    collect (policy + env, `collect_steps_per_iteration` lockstep steps)
    -> replay insert -> replay sample -> agent.train -> metric updates

and makes no host sync: no `.item()`, no boolean-mask indexing, no
data-dependent shapes, no host-to-device copies. The replay count and the
train step are host ints, so every branch the host takes is known without
asking the card. `run(n)` returns the n losses as one device tensor.

The JAX package compiles the iteration into one program; here it runs
eagerly, op by op, and the replay storage, parameters and optimizer state
are updated in place.

Prioritized replay plugs in as in the JAX package (:77-78, :122-157): a
replay with `update_priorities` is sampled with `per_beta`, its IS weights
go to ``agent.train(weights=...)``, and the loss's priorities go back:
its own per-sequence `priority` where it gives one (R2D2's mix of the max
and the mean of |td|), else its `td_error` (the mean of |td| over its
non-batch axes for a sequence loss). An agent whose loss has neither (C51:
a cross-entropy) gets a warning, once per loop.

Data parallelism (`mesh=`, the JAX loop's :68-73, :123-128, :158-163):
`init` still builds the state for the global batch B, and
`parallel.shard_loop_state` cuts it to this rank's B/n rows; `iteration`
then steps those rows, samples through the replay's `sample_sharded`
(shard-local, so no storage crosses ranks), and reduces what the JAX
partitioner reduces implicitly: the agent averages its gradients over the
mesh (`agent.mesh`), the reported loss scalars are the mean over the
ranks, and the metric deques are fed from every rank's rows.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Tuple

from agents_tpu_torch.drivers.torch_driver import DriverState, TorchDriver
from agents_tpu_torch.eval import metric_utils
from agents_tpu_torch.metrics import torch_metrics
from agents_tpu_torch.replay_buffers.uniform_replay import (UniformReplay,
                                                            check_shardable)
from agents_tpu_torch.utils import nest_utils, profiling
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import check_devices, resolve_device
from agents_tpu_torch.utils.draws import as_draws


# The iteration's spans (`utils/profiling.py`): one iteration is one
# request; its collect and each train step's replay sample are spans of
# their own, and the agent's train step opens its own.
_ITERATION = profiling.annotate("loop.iteration", request=True)
_COLLECT = profiling.annotate("loop.collect")
_SAMPLE = profiling.annotate("loop.sample")
_PRIORITIES = profiling.annotate("replay.priorities")


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
    replay: UniformReplay (or PrioritizedReplay) storing Trajectory
      frames.
    metrics: metrics updated during collection.
    collect_steps_per_iteration: driver steps per iteration.
    sample_batch_size: replay sample size for training.
    train_steps_per_iteration: gradient steps per iteration.
    per_beta: the IS-weight exponent of a prioritized replay.
    mesh: a `parallel.Mesh`: `iteration` then runs on this rank's share of
      a state cut by `parallel.shard_loop_state` (see the module
      docstring); the loop sets ``agent.mesh``.
    device: "cuda" unless the caller asks for "cpu"; env, agent and replay
      must live there too.
  """

  def __init__(self, env, agent, replay: UniformReplay, metrics=(),
               collect_steps_per_iteration: int = 1,
               sample_batch_size: int = 64,
               train_steps_per_iteration: int = 1, per_beta: float = 0.4,
               mesh=None, device="cuda"):
    self.device = resolve_device(device)
    check_devices(self.device, env=env, agent=agent, replay=replay)
    self.env = env
    self.agent = agent
    self.replay = replay
    self.metrics = tuple(metrics)
    self.collect_steps = collect_steps_per_iteration
    self.sample_batch_size = sample_batch_size
    self.train_steps = train_steps_per_iteration
    self.prioritized = hasattr(replay, "update_priorities")
    self.per_beta = per_beta
    self.mesh = mesh
    self._warned_no_td_error = False
    observers = [self.replay.add_batch] + [m.update for m in self.metrics]
    self.driver = TorchDriver(env, agent.collect_policy, observers=observers)
    self._iteration_driver = self.driver
    if mesh is not None:
      check_shardable(env.batch_size, sample_batch_size, mesh.size)
      agent.mesh = mesh
      local_replay = replay.local(mesh.size)
      self._iteration_driver = TorchDriver(
          env.with_batch_size(env.batch_size // mesh.size),
          agent.collect_policy,
          observers=[local_replay.add_batch] + [
              functools.partial(m.update, mesh=mesh) for m in self.metrics])

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

  def _collect(self, state: LoopState, num_steps: int,
               driver=None) -> LoopState:
    params = self.agent.collect_policy_params(state.agent_state)
    obs_states = (state.replay_state,) + tuple(state.metric_states)
    driver_state, obs_states = (driver or self.driver).run(
        params, state.driver_state, obs_states, state.draws, num_steps)
    return dataclasses.replace(state, driver_state=driver_state,
                               replay_state=obs_states[0],
                               metric_states=tuple(obs_states[1:]))

  def initial_collect(self, state: LoopState, num_steps: int) -> LoopState:
    """Seed replay with the collect policy."""
    return self._collect(state, num_steps)

  def _sample(self, replay_state, draws):
    """(experience, info) of one train step: shard-local with a mesh."""
    kwargs = dict(num_steps=self.agent.train_sequence_length)
    if self.prioritized:
      kwargs["beta"] = self.per_beta
    if self.mesh is None:
      return self.replay.sample(replay_state, draws, self.sample_batch_size,
                                **kwargs)
    return self.replay.sample_sharded(replay_state, draws,
                                      self.sample_batch_size, self.mesh,
                                      **kwargs)

  @_ITERATION
  def iteration(self, state: LoopState) -> Tuple[LoopState, LossInfo]:
    with _COLLECT:
      state = self._collect(state, self.collect_steps,
                            self._iteration_driver)
    agent_state, replay_state = state.agent_state, state.replay_state
    for _ in range(self.train_steps):
      with _SAMPLE:
        experience, info = self._sample(replay_state, state.draws)
      if self.prioritized:
        agent_state, loss_info = self.agent.train(
            agent_state, experience, weights=info.is_weights)
        with _PRIORITIES:
          replay_state = self._update_priorities(replay_state, info,
                                                 loss_info)
      else:
        agent_state, loss_info = self.agent.train(agent_state, experience)
    if self.mesh is not None:
      loss_info = self.mesh.mean_scalars(loss_info)
    return dataclasses.replace(state, agent_state=agent_state,
                               replay_state=replay_state), loss_info

  def _update_priorities(self, replay_state, info, loss_info):
    """The loss's priorities (its `priority`, else its TD errors) back to
    the replay; without them the items keep their insert-time max
    priority while the IS weights still bend the loss, so PER silently
    degrades to a biased uniform sampler."""
    td = getattr(loss_info.extra, "priority", None)
    if td is None:
      td = getattr(loss_info.extra, "td_error", None)
    if td is None:
      if not self._warned_no_td_error:
        self._warned_no_td_error = True
        warnings.warn(
            f"PrioritizedReplay paired with {type(self.agent).__name__}, "
            "whose LossInfo.extra has no td_error field: priorities will "
            "never be updated. Use UniformReplay, or expose td_error in the "
            "agent's loss extras.", stacklevel=3)
      return replay_state
    if td.dim() > 1:  # sequence losses: [S, T-1] -> per-item scalar
      td = td.abs().mean(dim=tuple(range(1, td.dim())))
    if self.mesh is None:
      return self.replay.update_priorities(replay_state, info, td)
    return self.replay.update_priorities_sharded(replay_state, info, td,
                                                 self.mesh)

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
