"""The SAC of ``examples/sac_pendulum_torch.py``: how the benchmark builds
it from a configuration file, hands it the benchmark's weights and draws,
reads its state, and which reference judges it.

The loop is the example's `build_loop` over its `Config` at the file's
fields. The agent's train step draws from its state's own source; the
benchmark hands it its seeded one, so the reference sees those draws too.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import flops
from portbench.programs import build_example
from portbench.reference import sac as REFERENCE

EXACT_RING = ("step_type", "observation", "next_step_type", "reward",
              "discount")
FOLLOW_NUMBERS = ("collect_gap",)
ROUNDING = None
NETWORKS = (("actor", "actor_network"), ("critic1", "critic1_network"),
            ("critic2", "critic2_network"),
            ("target_critic1", "target_critic1_network"),
            ("target_critic2", "target_critic2_network"))


def build(config: dict, device):
  """(loop, hyperparameters) of the example's loop at the file's fields."""
  loop, _, hp = build_example("examples.sac_pendulum_torch", config, device)
  return loop, hp


def leaves(hp):
  return REFERENCE.leaves(hp)


def _names(hp, prefix):
  return [name for name, *_ in leaves(hp) if name.startswith(prefix + ".")]


def load_weights(loop, hp, weights):
  """Copy the benchmark's weights into the actor and both critics (the
  targets are copied from them when the loop's state is made)."""
  agent = loop.agent
  with torch.no_grad():
    for prefix, module in (("actor", agent.actor_network),
                           ("critic1", agent.critic_network),
                           ("critic2", agent.critic_network_2)):
      params, names = list(module.parameters()), _names(hp, prefix)
      if len(params) != len(names):
        raise ValueError(f"{prefix}: {len(params)} parameters, "
                         f"{len(names)} leaves")
      for p, name in zip(params, names):
        p.copy_(weights[name])


def prepare(state, draws):
  """The agent's train step draws from the benchmark's source."""
  return dataclasses.replace(state, agent_state=dataclasses.replace(
      state.agent_state, draws=draws))


def _params(hp, agent_state):
  out = {}
  for prefix, field in NETWORKS:
    source = prefix.replace("target_", "")
    names = [f"{prefix}.{n.split('.', 1)[1]}" for n in _names(hp, source)]
    out.update(zip(names, getattr(agent_state, field).parameters()))
  out["log_alpha"] = agent_state.log_alpha
  return out


def state_leaves(hp, agent_state):
  return _params(hp, agent_state)


def first_grads(hp, agent_state):
  """The first step's gradients as the three optimizers got them, from
  Adam's first moments after one step (m = (1 - beta1) g)."""
  out = {}
  params = _params(hp, agent_state)
  for opt in (agent_state.actor_optimizer, agent_state.critic_optimizer,
              agent_state.alpha_optimizer):
    beta1 = opt.param_groups[0]["betas"][0]
    for name, p in params.items():
      if p in opt.state:
        out[name] = opt.state[p]["exp_avg"] / (1 - beta1)
  return out


def losses(loss_info):
  extra = loss_info.extra
  return {"critic_loss": extra.critic_loss, "actor_loss": extra.actor_loss,
          "alpha_loss": extra.alpha_loss}


def row_errors(loss_info):
  return None


def source_of(name: str) -> str:
  return name[len("target_"):] if name.startswith("target_") else name


def model(hp):
  """What the per-layer readers count with."""
  obs, act = hp["observation_size"], hp["action_size"]
  sample = hp["sample_batch_size"]
  actor, critic = hp["actor_fc_layers"], hp["critic_joint_fc_layers"]
  peak = flops.PEAKS[hp["peak"]]
  return {
      "peak": peak,
      "env_steps_per_iteration": hp["env_batch_size"],
      "train_steps_per_iteration": hp["train_steps_per_iteration"],
      "flops_per_train_step": flops.sac_train_step_flops(sample, obs, act,
                                                         actor, critic),
      "gemm_least_s_per_train_step": flops.dense_least_seconds(
          flops.sac_step_gemms(sample, obs, act, actor, critic), 4, peak),
  }
