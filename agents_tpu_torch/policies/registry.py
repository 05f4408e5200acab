"""Policy config registry: serializable policy-architecture configs.

Port of ``agents_tpu/policies/registry.py``. Together with
``networks.registry`` it makes a saved policy self-contained: the
manifest records which policy class (and wrapper stack) to rebuild and
the network configs inside it, and `build_policy` rebuilds the whole
object from the specs alone.

`policy_config` returns None for a policy it cannot represent (a custom
class, a callable epsilon or temperature, a splitter, an observation
normalizer, a CEM sampler other than the default or one with clippers);
such artifacts still save, but load only the explicit way (the caller
supplies the policy object). A class outside the dispatch table opts in
by defining ``policy_config(self) -> dict`` and registering a builder in
``POLICY_BUILDERS``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from agents_tpu_torch.networks import registry as net_registry

POLICY_BUILDERS: Dict[str, Callable] = {}


def _net_cfg(network) -> Optional[dict]:
  return getattr(network, "build_config", None)


def policy_config(policy) -> Optional[dict]:
  """Serializable config of `policy`, or None when unrepresentable."""
  from agents_tpu_torch.policies import actor_policy as ap
  from agents_tpu_torch.policies import cem_policy as cp
  from agents_tpu_torch.policies import q_policy as qp
  from agents_tpu_torch.policies import wrappers as w

  if hasattr(policy, "policy_config"):
    return policy.policy_config()

  # Wrappers: serialized recursively.
  simple_wrappers = (
      (w.GreedyPolicy, lambda p: {}),
      (w.EpsilonGreedyPolicy,
       lambda p: None if callable(p.epsilon) else {"epsilon": p.epsilon}),
      (w.BoltzmannPolicy,
       lambda p: None if callable(p.temperature)
       else {"temperature": p.temperature}),
      (w.GaussianPolicy, lambda p: {"scale": p.scale}),
      (w.OUNoisePolicy,
       lambda p: {"ou_stddev": p.ou_stddev, "ou_damping": p.ou_damping}),
  )
  for cls, kw_fn in simple_wrappers:
    if type(policy) is cls:
      kw = kw_fn(policy)
      inner = policy_config(policy.wrapped)
      if kw is None or inner is None:
        return None
      return {"type": cls.__name__, "kwargs": kw, "wrapped": inner}

  # Leaf policies.
  if type(policy) is qp.CategoricalQPolicy:
    if policy.splitter is not None or _net_cfg(policy.q_network) is None:
      return None
    return {"type": "CategoricalQPolicy",
            "network": _net_cfg(policy.q_network),
            "kwargs": {"min_q_value": policy.min_q_value,
                       "max_q_value": policy.max_q_value}}
  if type(policy) is qp.QPolicy:
    if policy.splitter is not None or _net_cfg(policy.q_network) is None:
      return None
    return {"type": "QPolicy", "network": _net_cfg(policy.q_network),
            "kwargs": {}}
  if type(policy) is ap.ActorPolicy:
    if (policy.observation_normalizer is not None
        or _net_cfg(policy.actor_network) is None):
      return None
    return {"type": "ActorPolicy",
            "network": _net_cfg(policy.actor_network), "kwargs": {}}
  if type(policy) is ap.DeterministicActorPolicy:
    if _net_cfg(policy.actor_network) is None:
      return None
    return {"type": "DeterministicActorPolicy",
            "network": _net_cfg(policy.actor_network), "kwargs": {}}
  if type(policy) is cp.CEMPolicy:
    from agents_tpu_torch.policies.cem_samplers import \
        GaussianContinuousSampler
    if (_net_cfg(policy.q_network) is None
        or type(policy.sampler) is not GaussianContinuousSampler
        # sample_clippers are arbitrary callables; dropping them would
        # rebuild a policy that proposes infeasible candidates.
        or getattr(policy.sampler, "sample_clippers", None)):
      return None
    return {"type": "CEMPolicy", "network": _net_cfg(policy.q_network),
            "kwargs": {"num_samples": policy.num_samples,
                       "num_elites": policy.num_elites,
                       "num_iterations": policy.num_iterations,
                       "initial_std": policy.initial_std}}
  return None


def build_policy(config: dict, time_step_spec, action_spec, device="cuda"):
  """Inverse of `policy_config`; the networks are built on `device`."""
  from agents_tpu_torch.policies import actor_policy as ap
  from agents_tpu_torch.policies import cem_policy as cp
  from agents_tpu_torch.policies import q_policy as qp
  from agents_tpu_torch.policies import wrappers as w

  kind = config["type"]
  if kind in POLICY_BUILDERS:
    return POLICY_BUILDERS[kind](config, time_step_spec, action_spec,
                                 device)

  wrapper_classes = {
      "GreedyPolicy": w.GreedyPolicy,
      "EpsilonGreedyPolicy": w.EpsilonGreedyPolicy,
      "BoltzmannPolicy": w.BoltzmannPolicy,
      "GaussianPolicy": w.GaussianPolicy,
      "OUNoisePolicy": w.OUNoisePolicy,
  }
  if kind in wrapper_classes:
    inner = build_policy(config["wrapped"], time_step_spec, action_spec,
                         device)
    return wrapper_classes[kind](inner, **config.get("kwargs", {}))

  leaf_classes = {
      "QPolicy": qp.QPolicy,
      "CategoricalQPolicy": qp.CategoricalQPolicy,
      "ActorPolicy": ap.ActorPolicy,
      "DeterministicActorPolicy": ap.DeterministicActorPolicy,
      "CEMPolicy": cp.CEMPolicy,
  }
  if kind not in leaf_classes:
    raise KeyError(f"Unknown policy type '{kind}' in saved manifest. "
                   f"Known: {sorted(leaf_classes) + sorted(wrapper_classes)}")
  network = net_registry.build_network(
      config["network"], time_step_spec.observation, action_spec, device)
  return leaf_classes[kind](time_step_spec, action_spec, network,
                            **config.get("kwargs", {}))


def policy_network(policy):
  """The network under `policy`'s wrappers: the params a rebuilt policy
  acts with."""
  while hasattr(policy, "wrapped"):
    policy = policy.wrapped
  for name in ("q_network", "actor_network"):
    if hasattr(policy, name):
      return getattr(policy, name)
  raise TypeError(f"{type(policy).__name__} holds no network")
