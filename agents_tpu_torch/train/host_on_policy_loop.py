"""On-policy training over host environments (PPO on MuJoCo).

Port of ``agents_tpu/train/host_on_policy_loop.py``: the host steps the
simulators with the collect policy acting on the card, then the stacked
``[B, T]`` rollout goes to one `agent.train` call. The policy outputs
(actions, value predictions, distribution parameters) stay on the device;
only the actions are read back for the simulators, once per env step.
The host time steps are kept as numpy and stacked once per iteration,
then copied to the device in one copy per leaf, where the JAX loop copies
each frame as it comes.
"""
from __future__ import annotations

import inspect
import time

import torch

from agents_tpu_torch.policies.jitted_py_policy import to_device, to_numpy
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import check_devices, resolve_device


class HostOnPolicyTrainLoop:
  """Args:
    env: a batched host env.
    agent: an on-policy Agent of the port (its collect policy acts).
    rollout_length: T, the host steps per iteration.
    py_metrics: numpy metrics called with each host frame.
    device: "cuda" unless the caller asks for "cpu"; the agent must live
      there too.

  `split` holds the last iteration's host seconds of collect (the T
  env steps and actions) and of stacking and copying the rollout.
  """

  def __init__(self, env, agent, rollout_length: int = 128, py_metrics=(),
               device="cuda"):
    self.device = resolve_device(device)
    check_devices(self.device, agent=agent)
    self.env = env
    self.agent = agent
    self.rollout_length = rollout_length
    self.py_metrics = list(py_metrics)
    self.split = {"collect_s": 0.0, "stack_copy_s": 0.0}
    self._train_takes_draws = "draws" in inspect.signature(
        agent.train).parameters

  def init(self, seed: int = 0):
    """(fresh agent state, the env's first time step). `run_iteration`
    takes a draw source, e.g. ``Draws(seed + 1, device)``, where the JAX
    loop takes a key."""
    del seed
    return self.agent.init(), self.env.reset()

  @torch.no_grad()
  def collect(self, agent_state, time_step, draws):
    """T host steps: (the last time step, experience ``[B, T]`` on the
    device)."""
    t0 = time.perf_counter()
    params = self.agent.collect_policy_params(agent_state)
    host_steps, actions, infos = [time_step], [], []
    for _ in range(self.rollout_length):
      step = self.agent.collect_policy.action(
          params, to_device(time_step, self.device), (), draws)
      action = to_numpy(step.action)
      next_time_step = self.env.step(action)
      if self.py_metrics:
        frame = tj.from_transition(time_step, ps.PolicyStep(action=action),
                                   next_time_step)
        for m in self.py_metrics:
          m(frame)
      actions.append(step.action)
      infos.append(step.info)
      host_steps.append(next_time_step)
      time_step = next_time_step
    t1 = time.perf_counter()
    steps = to_device(nest_utils.stack_nested_arrays(host_steps, axis=1),
                      self.device)                          # [B, T + 1]
    now = nest_utils.tree_map(lambda x: x[:, :-1], steps)
    nxt = nest_utils.tree_map(lambda x: x[:, 1:], steps)
    experience = tj.from_transition(
        now, ps.PolicyStep(
            action=nest_utils.stack_nested_tensors(actions, dim=1),
            info=nest_utils.stack_nested_tensors(infos, dim=1)), nxt)
    self.split = {"collect_s": t1 - t0,
                  "stack_copy_s": time.perf_counter() - t1}
    return time_step, experience

  def run_iteration(self, agent_state, time_step, draws):
    """Collect T host steps, then one `agent.train` on the rollout.
    Returns (agent_state, time_step, draws, loss_info)."""
    time_step, experience = self.collect(agent_state, time_step, draws)
    if self._train_takes_draws:
      agent_state, loss_info = self.agent.train(agent_state, experience,
                                                draws=draws)
    else:
      agent_state, loss_info = self.agent.train(agent_state, experience)
    return agent_state, time_step, draws, loss_info

  def metric_results(self):
    return {m.name: m.result() for m in self.py_metrics}
