"""QT-Opt's grasping Q-function of ``examples/qtopt_grasping_torch.py``:
how the benchmark builds it from a configuration file, hands it the
benchmark's weights and draws, reads its state, and which reference
judges it.

The loop is the example's `build_loop` over its `Config` at the file's
fields; nothing else of the program is imported here but its
`Trajectory`. Two things are added for the judge, neither of which
changes what the program computes:

  - `build` has the CEM policy keep, while the benchmark's draws record,
    the elites each CEM round picked (`record_elites`), beside the draws
    that made the candidates: the reference scores the same candidates,
    judges the choice and follows it (`reference/qtopt.py`), so a near-tie
    between two candidates, which float rounding may settle either way,
    changes no later step of the comparison;
  - `prepare` hands the train step's CEM the benchmark's draw source,
    and lets the replay's frames be read by the names the judge compares
    (`image`, `gripper_state`; `RingFrames`).
"""
from __future__ import annotations

import dataclasses

import torch

from agents_tpu_torch.trajectories.trajectory import Trajectory
from portbench import flops, qtopt
from portbench.programs import build_example
from portbench.reference import qtopt as REFERENCE

EXACT_RING = ("step_type", "image", "gripper_state", "action",
              "next_step_type", "reward", "discount")
FOLLOW_NUMBERS = ("cem_gap", "explore_mismatch")
# Float32 has no rounding of its own to measure the TD errors in: they are
# read as an RMS gap relative to the reference's (`td_rms_gap`).
ROUNDING = None


class RingFrames(Trajectory):
  """The replay's frames with the observation's leaves readable as
  attributes: ``image`` and ``gripper_state`` (the same tensors)."""

  def __getattr__(self, name):
    if name == "image":
      return self.observation["image"]
    if name == "gripper_state":
      return self.observation["state"]
    raise AttributeError(name)


def record_elites(policy):
  """While the draws passed to `policy.optimize` record, keep each CEM
  round's elites ``[B, E]`` among them at `REFERENCE.ELITES`."""
  sampler = policy.sampler
  optimize, refit = policy.optimize, sampler.refit_distribution_to
  current = {}

  def optimize_recorded(params, time_step, draws):
    current["draws"] = draws
    try:
      return optimize(params, time_step, draws)
    finally:
      current.clear()

  def refit_recorded(elite_idx, samples):
    draws = current.get("draws")
    if getattr(draws, "recording", False):
      draws.records[REFERENCE.ELITES].append(elite_idx.detach().clone())
    return refit(elite_idx, samples)

  policy.optimize = optimize_recorded
  sampler.refit_distribution_to = refit_recorded


def build(config: dict, device):
  """(loop, hyperparameters) of the example's loop at the file's fields."""
  loop, _, hp = build_example("examples.qtopt_grasping_torch", config,
                              device)
  record_elites(loop.agent.policy)
  return loop, hp


def leaves(hp):
  return REFERENCE.leaves(hp)


def _program_names(hp):
  """{reference leaf name: the program's parameter name}."""
  out = {}
  for kind in ("weight", "bias"):
    for i in range(len(hp["torso_conv_layer_params"])):
      out[f"torso{i}.{kind}"] = f"torso.convs.{i}.{kind}"
    for j in range(len(hp["merge_fc_layer_params"])):
      out[f"merge{j}.{kind}"] = f"merge.{j}.{kind}"
    for i in range(len(hp["head_conv_layer_params"])):
      out[f"head{i}.{kind}"] = f"head_stack.convs.{i}.{kind}"
    for j in range(len(hp["head_fc_layer_params"])):
      out[f"fc{j}.{kind}"] = f"head_stack.layers.{j}.{kind}"
    out[f"logit.{kind}"] = f"logit.{kind}"
  return {name: out[name] for name, *_ in leaves(hp)}


def _canonical(hp, module):
  params = dict(module.named_parameters())
  names = _program_names(hp)
  if set(params) != set(names.values()):
    raise ValueError(f"program parameters {sorted(params)} are not the "
                     f"reference's leaves {sorted(names)}")
  return {name: params[program] for name, program in names.items()}


def load_weights(loop, hp, weights):
  """Copy the benchmark's weights into the online critic (the target and
  the two delayed critics are copied from it when the loop's state is
  made)."""
  with torch.no_grad():
    for name, p in _canonical(hp, loop.agent.q_network).items():
      p.copy_(weights[name])


def prepare(state, draws):
  """The train step's CEM draws from the benchmark's source, and the
  ring's frames readable by the judge's names."""
  replay = state.replay_state
  frames = RingFrames(**{f.name: getattr(replay.storage, f.name)
                         for f in dataclasses.fields(replay.storage)})
  return dataclasses.replace(
      state, agent_state=dataclasses.replace(state.agent_state, draws=draws),
      replay_state=dataclasses.replace(replay, storage=frames))


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
  """The sample's TD errors ``[S]`` (zero where the frame is LAST)."""
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
      "flops_per_iteration": qtopt.iteration_flops(hp),
      "conv_least_s_per_iteration": qtopt.conv_least_s_per_iteration(
          hp, peak),
      "cem_least_s_per_iteration": qtopt.cem_least_s_per_iteration(hp, peak),
  }
