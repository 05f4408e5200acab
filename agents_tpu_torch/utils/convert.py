"""Carry weights from the JAX package's Q networks into the port.

Takes numpy only (``jax.device_get`` of the JAX side's params on the
caller's side), so it imports nothing of JAX. The flax tree of a Q
network is

    {"params": {"EncoderModule_0": {"Conv_0": {"kernel": [kh, kw, I, O],
                                               "bias": [O]}, ...,
                                    "Dense_0": {"kernel": [in, out],
                                                "bias": [out]}, ...},
                "Dense_0": ...}}

with one head `Dense_0` for `QModule` (the Q values) and
`CategoricalQModule` (the logits), and two for `DuelingQModule`:
`Dense_0` the value, `Dense_1` the advantages. A flax Dense kernel is
``[in, out]`` where a torch Linear weight is ``[out, in]``; a flax Conv
kernel is HWIO where a torch Conv2d weight is OIHW.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

_HEADS = {("Dense_0",): ("q_head",),
          ("Dense_0", "Dense_1"): ("value_head", "advantage_head")}


def _layers(tree: Mapping, prefix: str):
  """`tree`'s `prefix`_0, _1, ... entries, in order."""
  out = []
  while f"{prefix}_{len(out)}" in tree:
    out.append(tree[f"{prefix}_{len(out)}"])
  return out


def q_params_to_state_dict(params: Mapping) -> "collections.OrderedDict":
  """flax Q-network params -> the port module's `state_dict()` (in
  parameter order). Raises on an entry it does not know."""
  tree = params["params"]
  encoder = tree["EncoderModule_0"]
  out = collections.OrderedDict()
  convs, denses = _layers(encoder, "Conv"), _layers(encoder, "Dense")
  if len(encoder) != len(convs) + len(denses):
    raise ValueError(f"unexpected encoder entries: {sorted(encoder)}")
  for i, conv in enumerate(convs):
    out[f"encoder.convs.{i}.weight"] = _t(
        np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    out[f"encoder.convs.{i}.bias"] = _t(conv["bias"])
  for i, dense in enumerate(denses):
    out[f"encoder.layers.{i}.weight"] = _t(np.asarray(dense["kernel"]).T)
    out[f"encoder.layers.{i}.bias"] = _t(dense["bias"])
  heads = tuple(sorted(k for k in tree if k != "EncoderModule_0"))
  if heads not in _HEADS:
    raise ValueError(f"unexpected head entries: {list(heads)}")
  for flax_name, name in zip(heads, _HEADS[heads]):
    out[f"{name}.weight"] = _t(np.asarray(tree[flax_name]["kernel"]).T)
    out[f"{name}.bias"] = _t(tree[flax_name]["bias"])
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
