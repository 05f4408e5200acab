"""Training triggers.

Port of ``agents_tpu/train/triggers.py``: `IntervalTrigger`,
`StepPerSecondTracker`, `StepPerSecondLogTrigger`, and
`PolicyCheckpointTrigger`, which exports the greedy, collect and raw
policies (and, with a checkpointer, the agent state) every N steps.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable


class IntervalTrigger:
  """Fires `fn` every `interval` steps."""

  def __init__(self, interval: int, fn: Callable[[], None]):
    if interval <= 0:
      raise ValueError("interval must be > 0")
    self.interval = interval
    self.fn = fn
    self._last = 0

  def __call__(self, step: int, force: bool = False):
    if force or (step - self._last) >= self.interval:
      self._last = step - (step % self.interval)
      self.fn()
      return True
    return False

  def reset(self):
    self._last = 0

  def set_start(self, start: int):
    self._last = start


class StepPerSecondTracker:
  """Steps per second of wall time since the last `restart`."""

  def __init__(self):
    self.restart(0)

  def restart(self, step: int):
    self._t0 = time.time()
    self._step0 = step

  def steps_per_second(self, step: int) -> float:
    dt = time.time() - self._t0
    return (step - self._step0) / dt if dt > 0 else 0.0


class StepPerSecondLogTrigger(IntervalTrigger):
  """Logs the steps per second every `interval` steps."""

  def __init__(self, get_step: Callable[[], int], interval: int,
               log_fn=logging.info):
    self._get_step = get_step
    self._tracker = StepPerSecondTracker()
    self._log = log_fn

    def _fire():
      step = self._get_step()
      sps = self._tracker.steps_per_second(step)
      self._tracker.restart(step)
      self._log(f"step {step}: {sps:.1f} steps/s")

    super().__init__(interval, _fire)


class PolicyCheckpointTrigger(IntervalTrigger):
  """Exports ``root_dir/policies/{greedy_policy,collect_policy,policy}``
  (and saves the agent state through `checkpointer`, if given) every
  `interval` steps. ``policy`` is the raw policy under the greedy
  wrapper. Each directory is a self-contained artifact when its policy
  serializes (`policies.registry`): a fresh process restores it with
  ``load_policy(dir)`` alone.

  Each directory is written through `PolicySaver.publish`: the whole
  artifact the first time, the params and train step only after.
  """

  def __init__(self, root_dir: str, agent, get_agent_state: Callable,
               interval: int, checkpointer=None):
    from agents_tpu_torch.policies.policy_saver import PolicySaver
    self.root_dir = root_dir
    self.get_agent_state = get_agent_state
    self.checkpointer = checkpointer
    raw = getattr(agent.policy, "wrapped", agent.policy)
    self._savers = (
        ("greedy_policy", PolicySaver(agent.policy), agent.policy_params),
        ("collect_policy", PolicySaver(agent.collect_policy),
         agent.collect_policy_params),
        ("policy", PolicySaver(raw), agent.policy_params),
    )
    super().__init__(interval, self._fire)

  def _fire(self):
    agent_state = self.get_agent_state()
    step = int(agent_state.train_step)
    for name, saver, params in self._savers:
      saver.publish(os.path.join(self.root_dir, "policies", name),
                    params(agent_state), step)
    if self.checkpointer is not None:
      self.checkpointer.save(step, agent_state)
