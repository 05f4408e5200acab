"""Policy evaluation: on host environments, and over exactly N episodes on
a device environment.

Port of ``agents_tpu/eval/metric_utils.py``: `compute` (:19-31) runs a
host-facing policy (a `JittedPyPolicy`) on a host env through `PyDriver`
for `num_episodes` episodes. `evaluate_torch_env` (`evaluate_jax_env`,
:34-60) resets a fresh batch of device env rows and runs `policy` for a
fixed number of lockstep steps with `TorchDriver`.
`evaluate_torch_env_episodes` (:63-104) runs `TorchEpisodeDriver` until
every row has filled its episode quota; the overshoot frames are masked,
so the metrics count exactly `num_episodes` episodes. `MetricsGroup`
(:107-141) bundles host metrics into one checkpointable snapshot.
"""
from __future__ import annotations

import warnings
from typing import Sequence

from agents_tpu_torch.drivers.py_driver import PyDriver
from agents_tpu_torch.drivers.torch_driver import (TorchDriver,
                                                   TorchEpisodeDriver)
from agents_tpu_torch.metrics import torch_metrics


def compute(metrics: Sequence, environment, policy,
            num_episodes: int = 1) -> dict:
  """{metric name: result} of `metrics` (py metrics, reset first) over
  `num_episodes` episodes of `policy` on the host `environment`, from a
  reset. A stateful policy starts from its `init_state`."""
  for m in metrics:
    m.reset()
  driver = PyDriver(environment, policy, observers=list(metrics),
                    max_episodes=num_episodes)
  policy_state = (policy.init_state(environment.batch_size)
                  if hasattr(policy, "init_state") else ())
  driver.run(environment.reset(), policy_state)
  return {m.name: m.result() for m in metrics}


def evaluate_torch_env(env, policy, params, draws, num_steps: int,
                       metrics: Sequence = ()) -> dict:
  """{metric name: device scalar} of `policy` over `num_steps` lockstep
  steps of every row of `env`, from a reset; the env draws from `draws`.
  Use a length well above the episode horizon for an unbiased
  AverageReturn. The default metrics are `standard_collect_metrics(32)`."""
  metrics = tuple(metrics) or torch_metrics.standard_collect_metrics(
      buffer_size=32)
  driver = TorchDriver(env, policy, observers=[m.update for m in metrics])
  dstate = driver.init(draws)
  obs_states = tuple(m.init(env.batch_size, env.device) for m in metrics)
  _, obs_states = driver.run(params, dstate, obs_states, draws, num_steps)
  return {m.name: m.result(s) for m, s in zip(metrics, obs_states)}


def evaluate_torch_env_episodes(env, policy, params, draws,
                                num_episodes: int, max_steps: int = 10_000,
                                metrics: Sequence = ()) -> dict:
  """{metric name: device scalar} over exactly `num_episodes` episodes,
  plus "_steps" (`TorchEpisodeDriver`'s steps, its masked overshoot
  included) and "_episodes_completed" (host ints). The env reset and
  steps draw from `draws`. Warns when `max_steps` ran out first."""
  metrics = tuple(metrics) or torch_metrics.standard_collect_metrics(
      buffer_size=max(num_episodes, 10))
  driver = TorchEpisodeDriver(env, policy,
                              observers=[m.update for m in metrics])
  dstate = driver.init(draws)
  obs_states = tuple(m.init(env.batch_size, env.device) for m in metrics)
  _, obs_states, steps, completed = driver.run(
      params, dstate, obs_states, draws, num_episodes, max_steps)
  out = {m.name: m.result(s) for m, s in zip(metrics, obs_states)}
  out["_steps"] = steps
  out["_episodes_completed"] = completed
  if completed < num_episodes:
    warnings.warn(
        f"evaluate hit max_steps={max_steps} after only "
        f"{completed}/{num_episodes} episodes; metrics cover fewer "
        "episodes than requested")
  return out


class MetricsGroup:
  """A checkpointable bundle of host (py) metrics.

  Device metrics checkpoint with the loop state; host metrics keep their
  state in Python attributes, so this collects them into one plain-dict
  snapshot that JSON or `torch.save` can persist and restore.
  """

  def __init__(self, metrics, name: str = "metrics_group"):
    self.metrics = list(metrics)
    self.name = name

  def results(self):
    return {m.name: m.result() for m in self.metrics}

  def reset(self):
    for m in self.metrics:
      m.reset()

  def state_dict(self):
    """A JSON-serializable snapshot through each metric's `get_state`,
    which leaves out the per-row accumulators: on restore the host envs
    restart from a reset, so a revived accumulator would credit the old
    half-episode to the new one."""
    return {f"{i}:{m.name}": (m.get_state() if hasattr(m, "get_state")
                              else {})
            for i, m in enumerate(self.metrics)}

  def load_state_dict(self, state):
    for i, m in enumerate(self.metrics):
      st = state.get(f"{i}:{m.name}")
      if st is not None and hasattr(m, "set_state"):
        m.set_state(st)
