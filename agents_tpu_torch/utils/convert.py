"""Carry weights from the JAX package's networks into the port.

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

The SAC networks' trees are

    actor:  {"params": {"EncoderModule_0": {"Dense_0": ..., ...},
                        "TanhNormalProjection_0": {"Dense_0": ...}, ...}}
    critic: {"params": {"Dense_0": ..., ..., "Dense_n": ...}}

with one projection per action leaf, and the critic's observation layers,
then its joint layers, then its Q layer in `Dense_i` order.

The on-policy networks' trees are

    actor:  {"params": {"EncoderModule_0": ...,
                        "CategoricalProjection_0": {"Dense_0": ...}}}
            {"params": {"EncoderModule_0": ...,
                        "NormalProjection_0": {"Dense_0": ...,  # means
                                               ["Dense_1": ...,]  # stds
                                               "std_bias": [size]}}}
    value:  {"params": {"EncoderModule_0": ..., "Dense_0": ...}}

A `NormalProjection`'s own `std_bias` parameter comes first in the port
module's `state_dict()`, before its `means` (and `stds`) layers.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from agents_tpu_torch.utils.tensor_normalizer import StreamingNormalizerState

_HEADS = {("Dense_0",): ("q_head",),
          ("Dense_0", "Dense_1"): ("value_head", "advantage_head")}


def _layers(tree: Mapping, prefix: str):
  """`tree`'s `prefix`_0, _1, ... entries, in order."""
  out = []
  while f"{prefix}_{len(out)}" in tree:
    out.append(tree[f"{prefix}_{len(out)}"])
  return out


def _dense(out, name: str, dense: Mapping) -> None:
  out[f"{name}.weight"] = _t(np.asarray(dense["kernel"]).T)
  out[f"{name}.bias"] = _t(dense["bias"])


def _encoder(out, encoder: Mapping) -> None:
  """An `EncoderModule_0` subtree into `out` under ``encoder.``."""
  convs, denses = _layers(encoder, "Conv"), _layers(encoder, "Dense")
  if len(encoder) != len(convs) + len(denses):
    raise ValueError(f"unexpected encoder entries: {sorted(encoder)}")
  for i, conv in enumerate(convs):
    out[f"encoder.convs.{i}.weight"] = _t(
        np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    out[f"encoder.convs.{i}.bias"] = _t(conv["bias"])
  for i, dense in enumerate(denses):
    _dense(out, f"encoder.layers.{i}", dense)


def q_params_to_state_dict(params: Mapping) -> "collections.OrderedDict":
  """flax Q-network params -> the port module's `state_dict()` (in
  parameter order). Raises on an entry it does not know."""
  tree = params["params"]
  out = collections.OrderedDict()
  _encoder(out, tree["EncoderModule_0"])
  heads = tuple(sorted(k for k in tree if k != "EncoderModule_0"))
  if heads not in _HEADS:
    raise ValueError(f"unexpected head entries: {list(heads)}")
  for flax_name, name in zip(heads, _HEADS[heads]):
    _dense(out, name, tree[flax_name])
  return out


def sac_actor_params_to_state_dict(params: Mapping
                                   ) -> "collections.OrderedDict":
  """flax SAC actor params (`make_sac_actor_network`) -> the port
  `ActorDistributionModule`'s `state_dict()`."""
  tree = params["params"]
  out = collections.OrderedDict()
  _encoder(out, tree["EncoderModule_0"])
  heads = _layers(tree, "TanhNormalProjection")
  if len(tree) != 1 + len(heads) or not heads:
    raise ValueError(f"unexpected actor entries: {sorted(tree)}")
  for j, head in enumerate(heads):
    if set(head) != {"Dense_0"}:
      raise ValueError(f"unexpected projection entries: {sorted(head)}")
    _dense(out, f"projections.{j}.dense", head["Dense_0"])
  return out


def sac_critic_params_to_state_dict(params: Mapping
                                    ) -> "collections.OrderedDict":
  """flax critic params (`make_critic_network`) -> the port
  `CriticModule`'s `state_dict()`: every Dense but the last into
  `layers`, the last into `q_head`."""
  tree = params["params"]
  denses = _layers(tree, "Dense")
  if len(tree) != len(denses) or not denses:
    raise ValueError(f"unexpected critic entries: {sorted(tree)}")
  out = collections.OrderedDict()
  for i, dense in enumerate(denses[:-1]):
    _dense(out, f"layers.{i}", dense)
  _dense(out, "q_head", denses[-1])
  return out


def actor_params_to_state_dict(params: Mapping
                               ) -> "collections.OrderedDict":
  """flax actor params with `CategoricalProjection` or `NormalProjection`
  heads (`make_actor_distribution_network`) -> the port
  `ActorDistributionModule`'s `state_dict()`. The heads must be of one
  class (their order across classes is the action spec's, which the tree
  does not hold)."""
  tree = params["params"]
  out = collections.OrderedDict()
  _encoder(out, tree["EncoderModule_0"])
  kinds = [k for k in ("CategoricalProjection", "NormalProjection")
           if f"{k}_0" in tree]
  heads = _layers(tree, kinds[0]) if len(kinds) == 1 else []
  if len(tree) != 1 + len(heads) or not heads:
    raise ValueError(f"unexpected actor entries: {sorted(tree)}")
  for j, head in enumerate(heads):
    name = f"projections.{j}"
    if kinds[0] == "CategoricalProjection":
      if set(head) != {"Dense_0"}:
        raise ValueError(f"unexpected projection entries: {sorted(head)}")
      _dense(out, f"{name}.dense", head["Dense_0"])
      continue
    if set(head) not in ({"Dense_0", "std_bias"}, {"Dense_0", "Dense_1"}):
      raise ValueError(f"unexpected projection entries: {sorted(head)}")
    if "std_bias" in head:
      out[f"{name}.std_bias"] = _t(head["std_bias"])
    _dense(out, f"{name}.means", head["Dense_0"])
    if "Dense_1" in head:
      _dense(out, f"{name}.stds", head["Dense_1"])
  return out


def value_params_to_state_dict(params: Mapping
                               ) -> "collections.OrderedDict":
  """flax `ValueModule` params (`make_value_network`) -> the port
  `ValueModule`'s `state_dict()`."""
  tree = params["params"]
  if set(tree) != {"EncoderModule_0", "Dense_0"}:
    raise ValueError(f"unexpected value entries: {sorted(tree)}")
  out = collections.OrderedDict()
  _encoder(out, tree["EncoderModule_0"])
  _dense(out, "value_head", tree["Dense_0"])
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
  return {"q": q_params_to_state_dict(q_params),
          "target_q": q_params_to_state_dict(target_q_params),
          "adam_state": _adam_state(
              adam_count, q_params_to_state_dict(adam_mu).values(),
              q_params_to_state_dict(adam_nu).values()),
          "train_step": int(np.asarray(train_step))}


def _adam_state(count, mus, nus) -> Dict:
  """The "state" part of a `torch.optim.Adam` state dict, keyed by
  parameter index, from optax's count and moments in parameter order."""
  step = float(np.asarray(count))
  return {i: {"step": torch.tensor(step, dtype=torch.float32),
              "exp_avg": mu, "exp_avg_sq": nu}
          for i, (mu, nu) in enumerate(zip(mus, nus, strict=True))}


def _load_optimizer(optimizer, state: Dict) -> None:
  optimizer.load_state_dict({
      "state": state,
      "param_groups": optimizer.state_dict()["param_groups"]})


def load_dqn_agent_state(agent_state, converted: Dict):
  """Load `dqn_agent_state_to_torch`'s output into a port `DqnAgentState`
  (in place) and return it with the converted train step."""
  agent_state.q_network.load_state_dict(converted["q"])
  agent_state.target_q_network.load_state_dict(converted["target_q"])
  _load_optimizer(agent_state.optimizer, converted["adam_state"])
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])


# (JAX SacAgentState field, port SacAgentState field, converter)
_SAC_NETWORKS = (
    ("actor_params", "actor_network", sac_actor_params_to_state_dict),
    ("critic1_params", "critic1_network", sac_critic_params_to_state_dict),
    ("critic2_params", "critic2_network", sac_critic_params_to_state_dict),
    ("target_critic1_params", "target_critic1_network",
     sac_critic_params_to_state_dict),
    ("target_critic2_params", "target_critic2_network",
     sac_critic_params_to_state_dict))


def sac_agent_state_to_torch(state) -> Dict:
  """A whole JAX `SacAgentState` in port terms.

  Args:
    state: the JAX state with numpy leaves (``jax.device_get`` of it on the
      caller's side), its three optimizers ``optax.adam``: each optimizer
      state's first entry holds `count`, `mu` and `nu`. The critic
      optimizer's moments are ``(critic 1 tree, critic 2 tree)``.

  Returns a dict with the five networks' state dicts under the port
  state's field names ("actor_network", "critic1_network", ...,
  "target_critic2_network"), "log_alpha" (a 0-dim
  tensor), the "state" part of each `torch.optim.Adam` state dict
  ("actor_adam", "critic_adam" over critic 1's then critic 2's
  parameters, "alpha_adam") and "train_step" (int);
  `load_sac_agent_state` applies it.
  """
  out = {field: fn(getattr(state, jax_field))
         for jax_field, field, fn in _SAC_NETWORKS}
  actor, critic, alpha = (state.actor_opt_state[0], state.critic_opt_state[0],
                          state.alpha_opt_state[0])
  actor_sd = lambda t: sac_actor_params_to_state_dict(t).values()  # noqa
  critic_sd = lambda t: [  # noqa: E731
      v for tree in t for v in sac_critic_params_to_state_dict(tree).values()]
  out.update(
      log_alpha=_t(state.log_alpha),
      actor_adam=_adam_state(actor.count, actor_sd(actor.mu),
                             actor_sd(actor.nu)),
      critic_adam=_adam_state(critic.count, critic_sd(critic.mu),
                              critic_sd(critic.nu)),
      alpha_adam=_adam_state(alpha.count, [_t(alpha.mu)], [_t(alpha.nu)]),
      train_step=int(np.asarray(state.train_step)))
  return out


def load_sac_agent_state(agent_state, converted: Dict):
  """Load `sac_agent_state_to_torch`'s output into a port `SacAgentState`
  (in place) and return it with the converted train step."""
  for _, field, _ in _SAC_NETWORKS:
    getattr(agent_state, field).load_state_dict(converted[field])
  with torch.no_grad():
    agent_state.log_alpha.copy_(converted["log_alpha"])
  for name in ("actor", "critic", "alpha"):
    _load_optimizer(getattr(agent_state, f"{name}_optimizer"),
                    converted[f"{name}_adam"])
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])


def _on_policy_adam(opt_state, actor_value_sds):
  """The "state" part of a `torch.optim.Adam` state dict over the actor's,
  then the value network's parameters, from ``optax.adam`` over the tuple
  ``(actor, value)`` (its first entry holds count, mu and nu), and the
  count of a learning-rate schedule when the second entry has one."""
  adam = opt_state[0]
  moments = lambda tree: [  # noqa: E731
      v for sd, t in zip(actor_value_sds, tree) for v in sd(t).values()]
  rest = opt_state[1] if len(opt_state) > 1 else ()
  schedule = rest.count if "count" in getattr(rest, "_fields", ()) else None
  return (_adam_state(adam.count, moments(adam.mu), moments(adam.nu)),
          None if schedule is None else int(np.asarray(schedule)))


def _normalizer_state(state):
  """A JAX `StreamingNormalizerState` (numpy leaves) as the port's; ()
  stays ()."""
  if isinstance(state, tuple) and not state:
    return ()
  to_t = lambda nest: _map(nest, _t)  # noqa: E731
  return StreamingNormalizerState(count=to_t(state.count),
                                  mean_sum=to_t(state.mean_sum),
                                  var_sum=to_t(state.var_sum))


def _map(nest, fn):
  if isinstance(nest, Mapping):
    return {k: _map(v, fn) for k, v in nest.items()}
  if isinstance(nest, (tuple, list)):
    return type(nest)(_map(v, fn) for v in nest)
  return fn(nest)


def ppo_agent_state_to_torch(state) -> Dict:
  """A whole JAX `PPOAgentState` in port terms.

  Args:
    state: the JAX state with numpy leaves (``jax.device_get`` of it on the
      caller's side); its optimizer ``optax.adam`` over ``(actor, value)``,
      with a constant or a scheduled learning rate.

  Returns a dict with "actor_network" and "value_network" state dicts,
  "adam" (the "state" part of the `torch.optim.Adam` state dict over the
  actor's, then the value network's parameters), "schedule_count" (the
  learning-rate schedule's count, None without one), "obs_norm_state" and
  "reward_norm_state" (port `StreamingNormalizerState`s on the CPU, or
  ()), "kl_beta" (a 0-dim tensor) and "train_step" (int);
  `load_ppo_agent_state` applies it.
  """
  sds = (actor_params_to_state_dict, value_params_to_state_dict)
  adam, schedule_count = _on_policy_adam(state.opt_state, sds)
  return {"actor_network": sds[0](state.actor_params),
          "value_network": sds[1](state.value_params),
          "adam": adam, "schedule_count": schedule_count,
          "obs_norm_state": _normalizer_state(state.obs_norm_state),
          "reward_norm_state": _normalizer_state(state.reward_norm_state),
          "kl_beta": _t(state.kl_beta),
          "train_step": int(np.asarray(state.train_step))}


def _load_schedule(agent_state, count) -> None:
  """Set the `LambdaLR` of `agent_state` to the schedule's `count`."""
  scheduler = agent_state.lr_scheduler
  if (scheduler is None) != (count is None):
    raise ValueError("the learning-rate schedules of the two states differ")
  if scheduler is None:
    return
  scheduler.last_epoch = count
  for group, base, fn in zip(agent_state.optimizer.param_groups,
                             scheduler.base_lrs, scheduler.lr_lambdas):
    group["lr"] = base * fn(count)


def load_ppo_agent_state(agent_state, converted: Dict):
  """Load `ppo_agent_state_to_torch`'s output into a port `PPOAgentState`
  (in place) and return it with the converted normalizer states (moved to
  the agent's device), beta and train step."""
  agent_state.actor_network.load_state_dict(converted["actor_network"])
  agent_state.value_network.load_state_dict(converted["value_network"])
  _load_optimizer(agent_state.optimizer, converted["adam"])
  _load_schedule(agent_state, converted["schedule_count"])
  device = agent_state.kl_beta.device
  to_device = lambda st: () if st == () else StreamingNormalizerState(  # noqa
      *(_map(getattr(st, f.name), lambda x: x.to(device))
        for f in dataclasses.fields(st)))
  return dataclasses.replace(
      agent_state, obs_norm_state=to_device(converted["obs_norm_state"]),
      reward_norm_state=to_device(converted["reward_norm_state"]),
      kl_beta=converted["kl_beta"].to(device),
      train_step=converted["train_step"])


def reinforce_agent_state_to_torch(state) -> Dict:
  """A whole JAX `ReinforceAgentState` (numpy leaves, ``optax.adam`` over
  ``(actor, value)``) in port terms: "actor_network", "value_network"
  (None without a value network), "adam" and "train_step";
  `load_reinforce_agent_state` applies it."""
  has_value = not (isinstance(state.value_params, tuple)
                   and not state.value_params)
  sds = (actor_params_to_state_dict,) + (
      (value_params_to_state_dict,) if has_value else (lambda t: {},))
  adam, _ = _on_policy_adam(state.opt_state, sds)
  return {"actor_network": sds[0](state.actor_params),
          "value_network": sds[1](state.value_params) if has_value else None,
          "adam": adam, "train_step": int(np.asarray(state.train_step))}


def load_reinforce_agent_state(agent_state, converted: Dict):
  """Load `reinforce_agent_state_to_torch`'s output into a port
  `ReinforceAgentState` (in place) and return it with the converted train
  step."""
  agent_state.actor_network.load_state_dict(converted["actor_network"])
  if (agent_state.value_network is None) != (
      converted["value_network"] is None):
    raise ValueError("one state has a value network, the other none")
  if agent_state.value_network is not None:
    agent_state.value_network.load_state_dict(converted["value_network"])
  _load_optimizer(agent_state.optimizer, converted["adam"])
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])
