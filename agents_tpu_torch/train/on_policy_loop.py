"""The on-policy training iteration (PPO, REINFORCE).

Port of ``agents_tpu/train/on_policy_loop.py`` (:23-85): one `iteration`
collects a ``[T, B]`` rollout of `rollout_length` lockstep steps with the
collect policy (`TorchDriver` with `return_trajectories`), swaps it to
``[B, T]`` and hands it straight to `agent.train`; there is no replay.
An agent whose `train` takes `draws` (PPO's permutations) gets the loop's
draw source. The agent's train step is a host int, so an iteration makes
no host sync; `run(n)` returns the n losses as one device tensor, like
`FusedTrainLoop.run`.

With `mesh=` (data parallelism, like `FusedTrainLoop`'s): `init` builds the
state for the global batch, `parallel.shard_loop_state` cuts it to this
rank's rows, and `iteration` collects those rows and trains on them; the
agent (``agent.mesh``) averages its gradients and reduces its
whole-rollout statistics over the ranks, the reported loss scalars are
the mean over the ranks, and the metric deques are fed from every rank's
rows. PPO then needs `num_minibatch_shards` a multiple of the mesh's size.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Tuple

from agents_tpu_torch.drivers.torch_driver import DriverState, TorchDriver
from agents_tpu_torch.replay_buffers.uniform_replay import check_shardable
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import check_devices, resolve_device
from agents_tpu_torch.utils.draws import as_draws


@dataclasses.dataclass(frozen=True)
class OnPolicyLoopState:
  driver_state: DriverState
  agent_state: Any
  metric_states: Any
  draws: Any


class OnPolicyTrainLoop:
  """collect a rollout -> agent.train, one iteration at a time.

  Args:
    env: BatchedTorchEnv.
    agent: an on-policy Agent (its collect_policy drives collection).
    metrics: metrics updated during collection.
    rollout_length: T, the lockstep steps per iteration.
    mesh: a `parallel.Mesh` (see the module docstring); the loop sets
      ``agent.mesh``.
    device: "cuda" unless the caller asks for "cpu"; env and agent must
      live there too.
  """

  def __init__(self, env, agent, metrics=(), rollout_length: int = 128,
               mesh=None, device="cuda"):
    self.device = resolve_device(device)
    check_devices(self.device, env=env, agent=agent)
    self.env = env
    self.agent = agent
    self.metrics = tuple(metrics)
    self.rollout_length = rollout_length
    self.mesh = mesh
    self.driver = TorchDriver(env, agent.collect_policy,
                              observers=[m.update for m in self.metrics],
                              return_trajectories=True)
    self._iteration_driver = self.driver
    if mesh is not None:
      check_shardable(env.batch_size, None, mesh.size)
      agent.mesh = mesh
      self._iteration_driver = TorchDriver(
          env.with_batch_size(env.batch_size // mesh.size),
          agent.collect_policy,
          observers=[functools.partial(m.update, mesh=mesh)
                     for m in self.metrics],
          return_trajectories=True)
    self._train_takes_draws = "draws" in inspect.signature(
        agent.train).parameters

  def init(self, seed: int = 0, draws=None) -> OnPolicyLoopState:
    """Fresh state. Draws come from `draws`, or from a generator on the
    device seeded with `seed`."""
    draws = draws if draws is not None else as_draws(seed, self.device)
    return OnPolicyLoopState(
        agent_state=self.agent.init(),
        driver_state=self.driver.init(draws),
        metric_states=tuple(m.init(self.env.batch_size, self.device)
                            for m in self.metrics),
        draws=draws)

  def collect(self, state: OnPolicyLoopState):
    """One rollout: (state after it, experience [B, T, ...]); this rank's
    rows with a mesh."""
    params = self.agent.collect_policy_params(state.agent_state)
    driver_state, metric_states, frames = self._iteration_driver.run(
        params, state.driver_state, state.metric_states, state.draws,
        self.rollout_length)
    experience = nest_utils.tree_map(lambda x: x.transpose(0, 1), frames)
    return dataclasses.replace(state, driver_state=driver_state,
                               metric_states=metric_states), experience

  def iteration(self, state: OnPolicyLoopState
                ) -> Tuple[OnPolicyLoopState, LossInfo]:
    state, experience = self.collect(state)
    if self._train_takes_draws:
      agent_state, loss_info = self.agent.train(
          state.agent_state, experience, draws=state.draws)
    else:
      agent_state, loss_info = self.agent.train(state.agent_state,
                                                experience)
    if self.mesh is not None:
      loss_info = self.mesh.mean_scalars(loss_info)
    return dataclasses.replace(state, agent_state=agent_state), loss_info

  def run(self, state: OnPolicyLoopState, num_iterations: int):
    """`num_iterations` iterations; returns (state, losses [n] on device)."""
    state, infos = self.run_with_info(state, num_iterations)
    return state, infos.loss

  def run_with_info(self, state: OnPolicyLoopState, num_iterations: int):
    """Like `run` but returns the stacked LossInfo (loss and extras)."""
    infos = []
    for _ in range(num_iterations):
      state, info = self.iteration(state)
      infos.append(info)
    return state, nest_utils.stack_nested_tensors(infos)

  def results(self, state: OnPolicyLoopState):
    return {m.name: m.result(ms)
            for m, ms in zip(self.metrics, state.metric_states)}
