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

The deterministic (DDPG, TD3) actor's tree is

    {"params": {"EncoderModule_0": ..., "Dense_0": ...}}   # the action layer

The recurrent networks' trees (`lstm_networks`) hold an
`LSTMEncoderModule_0` where the others hold `EncoderModule_0`:

    {"LSTMEncoderModule_0": {"Dense_0": ..., ...,       # input, then output
                             "Scan_MaskedLSTMCell_0": {
                                 "OptimizedLSTMCell_0": {
                                     "ii", "if", "ig", "io": {"kernel"},
                                     "hi", "hf", "hg", "ho": {"kernel",
                                                              "bias"}}}}}

Its Dense layers are numbered input layers first, then output layers, so
the converters take the number of input layers. The four input kernels
``[in, H]`` become the port's one ``[4H, in]`` `lstm_input` weight and the
four recurrent kernels ``[H, H]`` and biases its `lstm_hidden` Linear,
gate blocks in the order i, f, g, o. A recurrent DQN or PPO agent state
crosses through `dqn_agent_state_to_torch` and `ppo_agent_state_to_torch`
given these converters, and loads with the same `load_*` functions.

Whole TD3, DDPG, QtOpt, CQL-SAC and behavioural-cloning agent states
cross with their Adams' moments and counts (`td3_agent_state_to_torch`,
`qtopt_agent_state_to_torch` and the others below, each with its
`load_*`). QtOpt's critic and its three targets are critic trees.

The host loops' state beyond the agent crosses too: a `UniformReplay`
state (`uniform_replay_state_to_torch`, `load_uniform_replay_state`; the
JAX storage unpacked, as small rows are) and the py-metric states of the
JAX async loop's checkpoint (`py_metric_states_to_torch`).
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


_GATES = ("i", "f", "g", "o")


def _lstm_encoder(out, encoder: Mapping, num_input_layers: int) -> None:
  """An `LSTMEncoderModule_0` subtree into `out` under ``encoder.``."""
  denses = _layers(encoder, "Dense")
  if (len(encoder) != len(denses) + 1 or not 0 <= num_input_layers
      <= len(denses)):
    raise ValueError(f"unexpected LSTM encoder entries: {sorted(encoder)} "
                     f"with {num_input_layers} input layers")
  cell = encoder["Scan_MaskedLSTMCell_0"]["OptimizedLSTMCell_0"]
  if set(cell) != {f"{k}{g}" for k in "ih" for g in _GATES}:
    raise ValueError(f"unexpected LSTM cell entries: {sorted(cell)}")
  for i, dense in enumerate(denses[:num_input_layers]):
    _dense(out, f"encoder.input_layers.{i}", dense)
  gates = lambda kind, leaf: [np.asarray(cell[f"{kind}{g}"][leaf])  # noqa
                              for g in _GATES]
  out["encoder.lstm_input.weight"] = _t(
      np.concatenate(gates("i", "kernel"), axis=1).T)
  out["encoder.lstm_hidden.weight"] = _t(
      np.concatenate(gates("h", "kernel"), axis=1).T)
  out["encoder.lstm_hidden.bias"] = _t(np.concatenate(gates("h", "bias")))
  for i, dense in enumerate(denses[num_input_layers:]):
    _dense(out, f"encoder.output_layers.{i}", dense)


def q_rnn_params_to_state_dict(params: Mapping, num_input_layers: int = 1
                               ) -> "collections.OrderedDict":
  """flax `QRnnModule` params (`make_q_rnn_network`) -> the port
  `QRnnModule`'s `state_dict()`."""
  tree = params["params"]
  if set(tree) != {"LSTMEncoderModule_0", "Dense_0"}:
    raise ValueError(f"unexpected Q RNN entries: {sorted(tree)}")
  out = collections.OrderedDict()
  _lstm_encoder(out, tree["LSTMEncoderModule_0"], num_input_layers)
  _dense(out, "q_head", tree["Dense_0"])
  return out


def value_rnn_params_to_state_dict(params: Mapping, num_input_layers: int = 1
                                   ) -> "collections.OrderedDict":
  """flax `ValueRnnModule` params (`make_value_rnn_network`) -> the port
  `ValueRnnModule`'s `state_dict()`."""
  tree = params["params"]
  if set(tree) != {"LSTMEncoderModule_0", "Dense_0"}:
    raise ValueError(f"unexpected value RNN entries: {sorted(tree)}")
  out = collections.OrderedDict()
  _lstm_encoder(out, tree["LSTMEncoderModule_0"], num_input_layers)
  _dense(out, "value_head", tree["Dense_0"])
  return out


def actor_rnn_params_to_state_dict(params: Mapping, num_input_layers: int = 1
                                   ) -> "collections.OrderedDict":
  """flax `ActorDistributionRnnModule` params
  (`make_actor_distribution_rnn_network`) -> the port module's
  `state_dict()`; its heads as in `actor_params_to_state_dict`."""
  tree = params["params"]
  out = collections.OrderedDict()
  _lstm_encoder(out, tree["LSTMEncoderModule_0"], num_input_layers)
  _actor_heads(out, tree, "LSTMEncoderModule_0")
  return out


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
  _actor_heads(out, tree, "EncoderModule_0")
  return out


def _actor_heads(out, tree: Mapping, encoder_key: str) -> None:
  """The `CategoricalProjection_j` or `NormalProjection_j` heads of an
  actor tree (all of one class) into `out` under ``projections.j``."""
  kinds = [k for k in ("CategoricalProjection", "NormalProjection")
           if f"{k}_0" in tree]
  heads = _layers(tree, kinds[0]) if len(kinds) == 1 else []
  if len(tree) != 1 + len(heads) or encoder_key not in tree or not heads:
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


def deterministic_actor_params_to_state_dict(params: Mapping
                                             ) -> "collections.OrderedDict":
  """flax `DeterministicActorModule` params
  (`make_deterministic_actor_network`) -> the port module's
  `state_dict()`."""
  tree = params["params"]
  if set(tree) != {"EncoderModule_0", "Dense_0"}:
    raise ValueError(f"unexpected deterministic actor entries: {sorted(tree)}")
  out = collections.OrderedDict()
  _encoder(out, tree["EncoderModule_0"])
  _dense(out, "action_head", tree["Dense_0"])
  return out


def _t(x) -> torch.Tensor:
  return torch.from_numpy(np.array(x, np.float32, order="C"))


def dqn_agent_state_to_torch(q_params: Mapping, target_q_params: Mapping,
                             adam_mu: Mapping, adam_nu: Mapping,
                             adam_count, train_step,
                             params_to_state_dict=q_params_to_state_dict
                             ) -> Dict:
  """A whole JAX `DqnAgentState` (optimizer ``optax.adam``) in port terms.

  Args:
    q_params, target_q_params: the online and target flax params.
    adam_mu, adam_nu, adam_count: optax's `ScaleByAdamState` fields.
    train_step: the agent's train step.
    params_to_state_dict: the network's converter
      (`q_rnn_params_to_state_dict` for a recurrent Q network).

  Returns a dict with "q" and "target_q" state dicts, "adam_state" (the
  "state" part of a `torch.optim.Adam` state dict, keyed by parameter
  index) and "train_step" (int); `load_dqn_agent_state` applies it.
  """
  sd = params_to_state_dict
  return {"q": sd(q_params), "target_q": sd(target_q_params),
          "adam_state": _adam_state(adam_count, sd(adam_mu).values(),
                                    sd(adam_nu).values()),
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


def ppo_agent_state_to_torch(
    state, actor_to_state_dict=actor_params_to_state_dict,
    value_to_state_dict=value_params_to_state_dict) -> Dict:
  """A whole JAX `PPOAgentState` in port terms.

  Args:
    state: the JAX state with numpy leaves (``jax.device_get`` of it on the
      caller's side); its optimizer ``optax.adam`` over ``(actor, value)``,
      with a constant or a scheduled learning rate.
    actor_to_state_dict, value_to_state_dict: the networks' converters
      (`actor_rnn_params_to_state_dict` and
      `value_rnn_params_to_state_dict` for recurrent networks).

  Returns a dict with "actor_network" and "value_network" state dicts,
  "adam" (the "state" part of the `torch.optim.Adam` state dict over the
  actor's, then the value network's parameters), "schedule_count" (the
  learning-rate schedule's count, None without one), "obs_norm_state" and
  "reward_norm_state" (port `StreamingNormalizerState`s on the CPU, or
  ()), "kl_beta" (a 0-dim tensor) and "train_step" (int);
  `load_ppo_agent_state` applies it.
  """
  sds = (actor_to_state_dict, value_to_state_dict)
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


def _adam_of(opt_state, converters, trees_of=lambda t: (t,)) -> Dict:
  """The "state" part of a `torch.optim.Adam` state dict from an
  ``optax.adam`` state (its first entry holds count, mu and nu); the
  moments are `trees_of(mu)` (a tuple of trees), each converted by the
  matching entry of `converters`, in parameter order."""
  adam = opt_state[0]
  moments = lambda tree: [  # noqa: E731
      v for fn, t in zip(converters, trees_of(tree), strict=True)
      for v in fn(t).values()]
  return _adam_state(adam.count, moments(adam.mu), moments(adam.nu))


_critic_sd = sac_critic_params_to_state_dict
_actor_sd = deterministic_actor_params_to_state_dict

# (JAX state field, port state field, converter)
_TD3_NETWORKS = (
    ("actor_params", "actor_network", _actor_sd),
    ("critic1_params", "critic1_network", _critic_sd),
    ("critic2_params", "critic2_network", _critic_sd),
    ("target_actor_params", "target_actor_network", _actor_sd),
    ("target_critic1_params", "target_critic1_network", _critic_sd),
    ("target_critic2_params", "target_critic2_network", _critic_sd))
_DDPG_NETWORKS = (
    ("actor_params", "actor_network", _actor_sd),
    ("critic_params", "critic_network", _critic_sd),
    ("target_actor_params", "target_actor_network", _actor_sd),
    ("target_critic_params", "target_critic_network", _critic_sd))


def td3_agent_state_to_torch(state) -> Dict:
  """A whole JAX `Td3AgentState` (numpy leaves; ``optax.adam`` for the
  actor and for the critics over ``(critic 1, critic 2)``) in port terms:
  the six networks' state dicts under the port state's field names,
  "actor_adam", "critic_adam" (critic 1's then critic 2's parameters) and
  "train_step"; `load_td3_agent_state` applies it."""
  out = {field: fn(getattr(state, jax_field))
         for jax_field, field, fn in _TD3_NETWORKS}
  out.update(actor_adam=_adam_of(state.actor_opt_state, (_actor_sd,)),
             critic_adam=_adam_of(state.critic_opt_state,
                                  (_critic_sd, _critic_sd), tuple),
             train_step=int(np.asarray(state.train_step)))
  return out


def ddpg_agent_state_to_torch(state) -> Dict:
  """A whole JAX `DdpgAgentState` (numpy leaves, two ``optax.adam``) in
  port terms: the four networks' state dicts, "actor_adam", "critic_adam"
  and "train_step"; `load_ddpg_agent_state` applies it."""
  out = {field: fn(getattr(state, jax_field))
         for jax_field, field, fn in _DDPG_NETWORKS}
  out.update(actor_adam=_adam_of(state.actor_opt_state, (_actor_sd,)),
             critic_adam=_adam_of(state.critic_opt_state, (_critic_sd,)),
             train_step=int(np.asarray(state.train_step)))
  return out


def _load_networks_and_adams(agent_state, converted, networks, adams):
  for _, field, _ in networks:
    getattr(agent_state, field).load_state_dict(converted[field])
  for name in adams:
    _load_optimizer(getattr(agent_state, f"{name}_optimizer"),
                    converted[f"{name}_adam"])
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])


def load_td3_agent_state(agent_state, converted: Dict):
  """Load `td3_agent_state_to_torch`'s output into a port `Td3AgentState`
  (in place) and return it with the converted train step."""
  return _load_networks_and_adams(agent_state, converted, _TD3_NETWORKS,
                                  ("actor", "critic"))


def load_ddpg_agent_state(agent_state, converted: Dict):
  """Load `ddpg_agent_state_to_torch`'s output into a port
  `DdpgAgentState` (in place) and return it with the converted train
  step."""
  return _load_networks_and_adams(agent_state, converted, _DDPG_NETWORKS,
                                  ("actor", "critic"))


_QTOPT_NETWORKS = (
    ("q_params", "q_network", _critic_sd),
    ("target_q_params", "target_q_network", _critic_sd),
    ("target_q_params_delayed", "target_q_network_delayed", _critic_sd),
    ("target_q_params_delayed_2", "target_q_network_delayed_2", _critic_sd))


def qtopt_agent_state_to_torch(state) -> Dict:
  """A whole JAX `QtOptAgentState` (numpy leaves, one ``optax.adam``) in
  port terms: the critic, its target and the two delayed targets' state
  dicts under the port state's field names (None where `enable_td3` is
  off), "adam" and "train_step"; `load_qtopt_agent_state` applies it."""
  out = {field: None if getattr(state, jax_field) is None
         else fn(getattr(state, jax_field))
         for jax_field, field, fn in _QTOPT_NETWORKS}
  out.update(adam=_adam_of(state.opt_state, (_critic_sd,)),
             train_step=int(np.asarray(state.train_step)))
  return out


def load_qtopt_agent_state(agent_state, converted: Dict):
  """Load `qtopt_agent_state_to_torch`'s output into a port
  `QtOptAgentState` (in place) and return it with the converted train
  step."""
  for _, field, _ in _QTOPT_NETWORKS:
    if (getattr(agent_state, field) is None) != (converted[field] is None):
      raise ValueError(f"one state has {field}, the other none")
    if converted[field] is not None:
      getattr(agent_state, field).load_state_dict(converted[field])
  _load_optimizer(agent_state.optimizer, converted["adam"])
  return dataclasses.replace(agent_state, train_step=converted["train_step"])


def cql_sac_agent_state_to_torch(state) -> Dict:
  """A whole JAX `CqlSacAgentState`: `sac_agent_state_to_torch`'s dict plus
  "log_cql_alpha" (a 0-dim tensor) and "cql_alpha_adam" (the Adam of
  `log_cql_alpha`); `load_cql_sac_agent_state` applies it."""
  adam = state.cql_alpha_opt_state[0]
  return {**sac_agent_state_to_torch(state),
          "log_cql_alpha": _t(state.log_cql_alpha),
          "cql_alpha_adam": _adam_state(adam.count, [_t(adam.mu)],
                                        [_t(adam.nu)])}


def load_cql_sac_agent_state(agent_state, converted: Dict):
  """Load `cql_sac_agent_state_to_torch`'s output into a port
  `CqlSacAgentState` (in place) and return it with the converted train
  step."""
  agent_state = load_sac_agent_state(agent_state, converted)
  with torch.no_grad():
    agent_state.log_cql_alpha.copy_(converted["log_cql_alpha"])
  _load_optimizer(agent_state.cql_alpha_optimizer,
                  converted["cql_alpha_adam"])
  return agent_state


def bc_agent_state_to_torch(state, params_to_state_dict) -> Dict:
  """A whole JAX `BcAgentState` (numpy leaves, ``optax.adam``) in port
  terms, its network converted by `params_to_state_dict` (e.g.
  `sac_actor_params_to_state_dict` or `q_params_to_state_dict`):
  "network", "adam" and "train_step"; `load_bc_agent_state` applies it."""
  return {"network": params_to_state_dict(state.params),
          "adam": _adam_of(state.opt_state, (params_to_state_dict,)),
          "train_step": int(np.asarray(state.train_step))}


def load_bc_agent_state(agent_state, converted: Dict):
  """Load `bc_agent_state_to_torch`'s output into a port `BcAgentState`
  (in place) and return it with the converted train step."""
  agent_state.network.load_state_dict(converted["network"])
  _load_optimizer(agent_state.optimizer, converted["adam"])
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])


_TRAJECTORY_FIELDS = ("step_type", "observation", "action", "policy_info",
                      "next_step_type", "reward", "discount")


def uniform_replay_state_to_torch(state) -> Dict:
  """A JAX `ReplayState` of Trajectory frames (numpy leaves, rows not
  packed) in port terms: "storage" ({field: nest of CPU tensors, dtypes
  kept}) and "count" (int); `load_uniform_replay_state` applies it."""
  storage = {f: _map(getattr(state.storage, f),
                     lambda x: torch.from_numpy(np.array(x)))
             for f in _TRAJECTORY_FIELDS}
  return {"storage": storage, "count": int(np.asarray(state.count))}


def load_uniform_replay_state(replay_state, converted: Dict):
  """Copy `uniform_replay_state_to_torch`'s output into a port
  `ReplayState`'s storage (in place) and return it with the count."""
  from agents_tpu_torch.utils import nest_utils

  for f in _TRAJECTORY_FIELDS:
    nest_utils.tree_map(lambda dst, src: dst.copy_(src),
                        getattr(replay_state.storage, f),
                        converted["storage"][f])
  return dataclasses.replace(replay_state, count=converted["count"])


def py_metric_states_to_torch(saved) -> list:
  """The "metrics" entry of the JAX async loop's checkpoint (per metric a
  deque padded to its maxlen with its length, or a count) as the
  `set_state` dicts of the port's py metrics."""
  out = []
  for st in saved:
    if "buffer" in st:
      n = int(np.asarray(st["n"]))
      out.append({"buffer": [float(v) for v in np.asarray(st["buffer"])[:n]]})
    else:
      out.append({"count": int(np.asarray(st["count"]))})
  return out


# -- bandits -----------------------------------------------------------------

def dense_stack_params_to_state_dict(params: Mapping, module
                                     ) -> "collections.OrderedDict":
  """flax params whose only entries are ``Dense_0 .. Dense_n`` (the
  bandits' `GlobalAndArmFeatureModule`, `HeteroscedasticQModule`, the
  examples' dropout network) -> the `state_dict()` of `module`, whose
  Linear layers, in registration order, are those Denses in creation
  order."""
  tree = params["params"]
  denses = _layers(tree, "Dense")
  names = [n for n, m in module.named_modules()
           if isinstance(m, torch.nn.Linear)]
  if len(tree) != len(denses) or len(denses) != len(names):
    raise ValueError(f"{sorted(tree)} does not match the Linear layers "
                     f"{names}")
  out = collections.OrderedDict()
  for name, dense in zip(names, denses):
    _dense(out, name, dense)
  return out


def neural_linucb_params_to_state_dict(params: Mapping
                                       ) -> "collections.OrderedDict":
  """flax params of the JAX `NeuralLinUcbAgent`'s encoder with its reward
  head ({"encoder": an `EncoderModule` tree, "Dense_0": the head}) -> the
  port `EncoderWithRewardHead`'s `state_dict()` (its encoder an
  `EncodingNetwork`)."""
  tree = params["params"]
  if set(tree) != {"encoder", "Dense_0"}:
    raise ValueError(f"unexpected NeuralLinUCB entries: {sorted(tree)}")
  inner = collections.OrderedDict()
  _encoder(inner, tree["encoder"])
  out = collections.OrderedDict(
      (f"encoder.{k}", v) for k, v in inner.items())
  _dense(out, "head", tree["Dense_0"])
  return out


def reward_net_agent_state_to_torch(state, params_to_state_dict) -> Dict:
  """A JAX bandit `RewardNetAgentState` (numpy leaves, ``optax.adam``) in
  port terms: "params" (the reward network's state dict, or with
  constraints {"reward": ..., "constraints": (...)} of them), "adam"
  (moments in the port's parameter order: the reward network's, then each
  constraint network's) and "train_step". `params_to_state_dict` converts
  one network's params; for constrained params it is a
  {"reward": fn, "constraints": (fn, ...)} dict of them."""
  if isinstance(params_to_state_dict, Mapping):
    fns = (params_to_state_dict["reward"],) + tuple(
        params_to_state_dict["constraints"])
    trees = lambda t: (t["reward"],) + tuple(t["constraints"])  # noqa
    params = {"reward": fns[0](state.params["reward"]),
              "constraints": tuple(fn(p) for fn, p in zip(
                  fns[1:], state.params["constraints"]))}
  else:
    fns, trees = (params_to_state_dict,), lambda t: (t,)
    params = params_to_state_dict(state.params)
  return {"params": params, "adam": _adam_of(state.opt_state, fns, trees),
          "train_step": int(np.asarray(state.train_step))}


def load_reward_net_agent_state(agent_state, converted: Dict):
  """Load `reward_net_agent_state_to_torch`'s output into a port
  `RewardNetAgentState` (in place) and return it with the converted train
  step."""
  params = agent_state.params
  if isinstance(params, torch.nn.Module):
    params.load_state_dict(converted["params"])
  else:
    params["reward"].load_state_dict(converted["params"]["reward"])
    for module, sd in zip(params["constraints"],
                          converted["params"]["constraints"]):
      module.load_state_dict(sd)
  _load_optimizer(agent_state.optimizer, converted["adam"])
  return dataclasses.replace(agent_state,
                             train_step=converted["train_step"])
