"""R2D2 of ``examples/dqn_pixels_torch.py`` (``agent="r2d2"``): how the
benchmark builds it from a configuration file, hands it the benchmark's
weights, reads its state, and which reference judges it.

The loop is the example's `build_loop` over its `Config` at the file's
fields; nothing else of the program is imported here.
"""
from __future__ import annotations

import torch

from portbench import flops, lstm
from portbench.programs import build_example
from portbench.reference import r2d2 as REFERENCE

EXACT_RING = ("step_type", "observation", "action", "next_step_type",
              "reward", "discount")
FOLLOW_NUMBERS = ("greedy_gap", "explore_mismatch")
# Float32 has no rounding of its own to measure the TD errors in: they are
# read as an RMS gap relative to the reference's (`td_rms_gap`).
ROUNDING = None


def build(config: dict, device):
  """(loop, hyperparameters) of the example's loop at the file's fields."""
  loop, cfg, hp = build_example("examples.dqn_pixels_torch", config, device)
  if (cfg.env, cfg.agent, cfg.scale_pixels, cfg.dtype) != (
      "pixels", "r2d2", True, "float32"):
    raise ValueError("the reference covers R2D2 over scaled synthetic "
                     "frames in float32 only")
  return loop, hp


def leaves(hp):
  return REFERENCE.leaves(hp)


def _program_names(hp):
  """{reference leaf name: the program's parameter name}."""
  out = {}
  for i in range(len(hp["conv_layer_params"])):
    for kind in ("weight", "bias"):
      out[f"conv{i}.{kind}"] = f"torso.convs.{i}.{kind}"
  for j in range(len(hp["fc_layer_params"])):
    for kind in ("weight", "bias"):
      out[f"fc{j}.{kind}"] = f"torso.layers.{j}.{kind}"
  out["lstm.input_weight"] = "core.lstm_input.weight"
  out["lstm.hidden_weight"] = "core.lstm_hidden.weight"
  out["lstm.bias"] = "core.lstm_hidden.bias"
  for stream in ("value", "advantage"):
    for j in range(len(hp["dueling_fc_layer_params"])):
      for kind in ("weight", "bias"):
        out[f"{stream}{j}.{kind}"] = f"{stream}_layers.{j}.{kind}"
    for kind in ("weight", "bias"):
      out[f"{stream}_head.{kind}"] = f"{stream}_head.{kind}"
  return out


def _canonical(hp, module):
  params = dict(module.named_parameters())
  names = _program_names(hp)
  if set(params) != set(names.values()):
    raise ValueError(f"program parameters {sorted(params)} are not the "
                     f"reference's leaves {sorted(names)}")
  return {name: params[program] for name, program in names.items()}


def load_weights(loop, hp, weights):
  """Copy the benchmark's weights into the online Q network (the target
  is copied from it when the loop's state is made)."""
  with torch.no_grad():
    for name, p in _canonical(hp, loop.agent.q_network).items():
      p.copy_(weights[name])


def prepare(state, draws):
  return state


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
  """The sample's per-frame TD errors ``[S, L]`` over the trained frames
  (zero where a position is not valid)."""
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
  peak = flops.PEAKS[hp["peak"]]
  return {
      "peak": peak,
      "env_steps_per_iteration": hp["env_batch_size"],
      "train_steps_per_iteration": 1,
      "flops_per_iteration": lstm.r2d2_iteration_flops(hp),
      "lstm_least_s_per_iteration": lstm.recurrence_least_seconds(hp, peak),
  }
