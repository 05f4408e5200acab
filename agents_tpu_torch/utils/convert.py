"""Carry weights from the JAX package's Q network into the port.

Takes numpy only (``jax.device_get`` of the JAX side's params on the
caller's side), so it imports nothing of JAX. The flax tree that
``make_q_network(..., fc_layer_params=(100, 50))`` builds is

    {"params": {"EncoderModule_0": {"Dense_0": {"kernel": [4, 100], "bias"},
                                    "Dense_1": {"kernel": [100, 50], "bias"}},
                "Dense_0": {"kernel": [50, 2], "bias"}}}

A flax Dense kernel is ``[in, out]``; a torch Linear weight is ``[out, in]``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch


def q_params_to_state_dict(params: Mapping) -> "collections.OrderedDict":
  """flax QModule params -> `QModule.state_dict()` (in parameter order)."""
  tree = params["params"]
  encoder = tree["EncoderModule_0"]
  out = collections.OrderedDict()
  i = 0
  while f"Dense_{i}" in encoder:
    dense = encoder[f"Dense_{i}"]
    out[f"encoder.layers.{i}.weight"] = _t(np.asarray(dense["kernel"]).T)
    out[f"encoder.layers.{i}.bias"] = _t(dense["bias"])
    i += 1
  if len(encoder) != i:
    raise ValueError(f"unexpected encoder entries: {sorted(encoder)}")
  head = tree["Dense_0"]
  out["q_head.weight"] = _t(np.asarray(head["kernel"]).T)
  out["q_head.bias"] = _t(head["bias"])
  return out


def _t(x) -> torch.Tensor:
  return torch.from_numpy(np.array(x, np.float32, order="C"))


def dqn_agent_state_to_torch(q_params: Mapping, target_q_params: Mapping,
                             adam_mu: Mapping, adam_nu: Mapping,
                             adam_count, train_step) -> Dict:
  """A whole JAX `DqnAgentState` (optimizer ``optax.adam``) in port terms.

  Args:
    q_params, target_q_params: the online and target flax params.
    adam_mu, adam_nu, adam_count: optax's `ScaleByAdamState` fields.
    train_step: the agent's train step.

  Returns a dict with "q" and "target_q" state dicts, "adam_state" (the
  "state" part of a `torch.optim.Adam` state dict, keyed by parameter
  index) and "train_step" (int); `load_dqn_agent_state` applies it.
  """
  mu = q_params_to_state_dict(adam_mu)
  nu = q_params_to_state_dict(adam_nu)
  step = float(np.asarray(adam_count))
  adam_state = {
      i: {"step": torch.tensor(step, dtype=torch.float32),
          "exp_avg": mu[name], "exp_avg_sq": nu[name]}
      for i, name in enumerate(mu)}
  return {"q": q_params_to_state_dict(q_params),
          "target_q": q_params_to_state_dict(target_q_params),
          "adam_state": adam_state,
          "train_step": int(np.asarray(train_step))}


def load_dqn_agent_state(agent_state, converted: Dict):
  """Load `dqn_agent_state_to_torch`'s output into a port `DqnAgentState`
  (in place) and return it with the converted train step."""
  agent_state.q_network.load_state_dict(converted["q"])
  agent_state.target_q_network.load_state_dict(converted["target_q"])
  optimizer = agent_state.optimizer
  optimizer.load_state_dict({
      "state": converted["adam_state"],
      "param_groups": optimizer.state_dict()["param_groups"]})
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])
