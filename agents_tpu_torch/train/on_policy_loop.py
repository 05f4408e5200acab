"""The on-policy training iteration (PPO, REINFORCE).

Port of ``agents_tpu/train/on_policy_loop.py`` (:23-85): one `iteration`
collects a ``[T, B]`` rollout of `rollout_length` lockstep steps with the
collect policy (`TorchDriver` with `return_trajectories`), swaps it to
``[B, T]`` and hands it straight to `agent.train`; there is no replay.
An agent whose `train` takes `draws` (PPO's permutations) gets the loop's
draw source. The agent's train step is a host int, so an iteration makes
no host sync; `run(n)` returns the n losses as one device tensor, like
`FusedTrainLoop.run`.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Tuple

from agents_tpu_torch.drivers.torch_driver import DriverState, TorchDriver
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
    device: "cuda" unless the caller asks for "cpu"; env and agent must
      live there too.
  """

  def __init__(self, env, agent, metrics=(), rollout_length: int = 128,
               device="cuda"):
    self.device = resolve_device(device)
    check_devices(self.device, env=env, agent=agent)
    self.env = env
    self.agent = agent
    self.metrics = tuple(metrics)
    self.rollout_length = rollout_length
    self.driver = TorchDriver(env, agent.collect_policy,
                              observers=[m.update for m in self.metrics],
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
    """One rollout: (state after it, experience [B, T, ...])."""
    params = self.agent.collect_policy_params(state.agent_state)
    driver_state, metric_states, frames = self.driver.run(
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
