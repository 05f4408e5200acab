"""The pixel DQN of ``examples/dqn_pixels_torch.py``: how the benchmark
builds it from a configuration file, hands it the benchmark's weights,
reads its state, and which reference judges it.

The loop is the example's `build_loop` over its `Config` at the file's
fields; nothing else of the program is imported here.
"""
from __future__ import annotations

import torch

from portbench import flops
from portbench.programs import build_example
from portbench.reference import common
from portbench.reference import dqn as REFERENCE

EXACT_RING = ("step_type", "observation", "action", "next_step_type",
              "reward", "discount")
FOLLOW_NUMBERS = ("greedy_gap", "explore_mismatch")
# The configuration's own rounding: the TD-error gap is read in units of
# the gap a bfloat16 reference has.
ROUNDING = "bfloat16"


def build(config: dict, device):
  """(loop, hyperparameters) of the example's loop at the file's fields."""
  loop, cfg, hp = build_example("examples.dqn_pixels_torch", config, device)
  if (cfg.env, cfg.agent, cfg.td_loss, cfg.scale_pixels) != (
      "pixels", "dqn", "huber", True):
    raise ValueError("the reference covers DQN with the Huber loss over "
                     "scaled synthetic frames only")
  return loop, hp


def leaves(hp):
  return REFERENCE.leaves(hp)


def load_weights(loop, hp, weights):
  """Copy the benchmark's weights into the online Q network (the target
  is copied from it when the loop's state is made)."""
  with torch.no_grad():
    params = list(loop.agent.q_network.parameters())
    names = [name for name, *_ in leaves(hp)]
    if len(params) != len(names):
      raise ValueError(f"{len(params)} parameters, {len(names)} leaves")
    for p, name in zip(params, names):
      p.copy_(weights[name])


def prepare(state, draws):
  return state


def _canonical(hp, module):
  return dict(zip((name for name, *_ in leaves(hp)), module.parameters()))


def state_leaves(hp, agent_state):
  out = {f"q.{k}": v for k, v in _canonical(hp, agent_state.q_network).items()}
  out.update({f"target.{k}": v for k, v in
              _canonical(hp, agent_state.target_q_network).items()})
  return out


def first_grads(hp, agent_state):
  """The first step's gradient as the optimizer got it, from Adam's first
  moment after one step (m = (1 - beta1) g)."""
  opt = agent_state.optimizer
  beta1 = opt.param_groups[0]["betas"][0]
  return {f"q.{k}": opt.state[p]["exp_avg"] / (1 - beta1)
          for k, p in _canonical(hp, agent_state.q_network).items()}


def losses(loss_info):
  return {"loss": loss_info.loss}


def row_errors(loss_info):
  """The sample's per-row TD errors (zero where the step is LAST)."""
  return loss_info.extra.td_error


def train_step(agent_state) -> int:
  return agent_state.train_step


def target_update_step(hp, agent_state) -> int:
  """The next train step after which the target network is updated (the
  agent updates it where the step, counted from 1, is a multiple of the
  period)."""
  period = hp["target_update_period"]
  return (agent_state.train_step // period + 1) * period


def source_of(name: str) -> str:
  return "q." + name.split(".", 1)[1] if name.startswith("target.") else name


def model(hp):
  """What the per-layer readers count with."""
  size, frames = hp["pixels_size"], hp["pixels_frames"]
  convs, fc = hp["conv_layer_params"], hp["fc_layer_params"]
  actions = hp["pixels_actions"]
  batch, sample = hp["env_batch_size"], hp["sample_batch_size"]
  return {
      "peak": flops.PEAKS[hp["peak"]],
      "env_steps_per_iteration": batch,
      "train_steps_per_iteration": 1,
      "flops_per_iteration": flops.conv_iteration_flops(
          size, frames, actions, batch, sample, convs, fc),
      "flops_per_call": flops.conv_forward_flops(size, frames, actions,
                                                 convs, fc),
      "conv_least_s_per_iteration": flops.conv_least_seconds(
          size, frames, convs, batch, sample, 2, flops.PEAKS[hp["peak"]]),
  }


def policy(loop):
  """(the greedy policy, its params) as a trained policy is exported."""
  return loop.agent.policy, loop.agent.q_network


def act_q_values(hp, weights, obs, precision):
  """Reference Q values of uint8 frames, in blocks of 256."""
  out = []
  with torch.no_grad(), common.precision_flags(precision):
    for i in range(0, obs.shape[0], 256):
      out.append(REFERENCE.q_values(weights, obs[i:i + 256], hp, precision))
  return torch.cat(out)
