"""Actor: the host-env collection shell.

Port of ``agents_tpu/train/actor.py``: `PyDriver` plus metrics and
summaries, with `run` / `run_and_log` / `write_metric_summaries`, and the
collect and eval metric presets.
"""
from __future__ import annotations

import logging
from typing import Sequence

from agents_tpu_torch.drivers.py_driver import PyDriver
from agents_tpu_torch.metrics import py_metrics


def collect_metrics(buffer_size: int = 10):
  return [
      py_metrics.EnvironmentSteps(),
      py_metrics.NumberOfEpisodes(),
      py_metrics.AverageReturnMetric(buffer_size),
      py_metrics.AverageEpisodeLengthMetric(buffer_size),
  ]


def eval_metrics(eval_episodes: int = 10):
  return [
      py_metrics.AverageReturnMetric(eval_episodes),
      py_metrics.AverageEpisodeLengthMetric(eval_episodes),
  ]


class Actor:
  """Runs a host-facing `policy` (numpy in, numpy out) on the host `env`
  for `steps_per_run` steps or `episodes_per_run` episodes per `run`,
  carrying the time step and policy state across runs."""

  def __init__(self, env, policy, train_step_fn=None, steps_per_run=None,
               episodes_per_run=None, observers: Sequence = (),
               metrics: Sequence = (), summary_writer=None,
               summary_interval: int = 1000, name: str = ""):
    self.env = env
    self.policy = policy
    self.metrics = list(metrics)
    # None (an eval actor without a learner handle) keys summaries on the
    # actor's own run count, with no interval gate.
    self._train_step_fn = train_step_fn
    self._num_runs = 0
    self.driver = PyDriver(env, policy,
                           observers=list(observers) + self.metrics,
                           max_steps=steps_per_run,
                           max_episodes=episodes_per_run)
    self.summary_writer = summary_writer
    self.summary_interval = summary_interval
    self._last_summary = 0
    self.name = name
    self._time_step = None
    self._policy_state = policy.init_state(env.batch_size)

  def reset(self):
    self._time_step = self.env.reset()
    self._policy_state = self.policy.init_state(self.env.batch_size)

  def run(self):
    if self._time_step is None:
      self.reset()
    self._time_step, self._policy_state = self.driver.run(
        self._time_step, self._policy_state)
    self._num_runs += 1

  def run_and_log(self):
    self.run()
    self.log_metrics()

  def log_metrics(self):
    results = {m.name: m.result() for m in self.metrics}
    logging.info("%s metrics: %s", self.name or "actor", results)
    return results

  def write_metric_summaries(self):
    if self.summary_writer is None:
      return
    if self._train_step_fn is None:
      step = self._num_runs  # no gate: every call writes, x = run count
    else:
      step = int(self._train_step_fn())
      if step - self._last_summary < self.summary_interval:
        return
      self._last_summary = step
    for m in self.metrics:
      self.summary_writer.scalar(
          f"{self.name}/{m.name}" if self.name else m.name, m.result(),
          step)
