"""Network factory registry: serializable architecture configs.

Port of ``agents_tpu/networks/registry.py``. Every ``make_*_network``
factory is registered and stamps the network it returns with how it was
called (``build_config``); `build_network` calls the factory again from
that config and the specs stored in a policy manifest.

Only JSON-representable arguments are recorded; the well-known non-JSON
values (activations, dtypes, projection classes) are encoded by name. A
call with an unrepresentable argument (a custom ``preprocessing``
callable, a ``functools.partial`` projection) yields ``build_config =
None``, and such a policy loads only the explicit way (the caller passes
the policy object).

Unlike the JAX factories, the port's take ``device`` and ``generator``.
Neither is recorded: a generator is not JSON, and a recorded "cuda" would
rebuild on the card in a CPU-only loader. `build_network` takes the
device from its caller; the weights come from the saved parameters.
"""
from __future__ import annotations

import functools
import inspect
import json
from typing import Callable, Dict

import torch
import torch.nn.functional as F

FACTORY_REGISTRY: Dict[str, Callable] = {}

# Arguments a build_config leaves out: the specs come from the manifest,
# the device from the loader, and the weights from the saved parameters.
_UNRECORDED = ("input_spec", "observation_spec", "action_spec", "device",
               "generator")

_NAMED_VALUES = {
    "relu": F.relu, "tanh": torch.tanh, "elu": F.elu, "gelu": F.gelu,
    "sigmoid": torch.sigmoid, "swish": F.silu,
}
# The same functions reached by other names.
_ALIASES = {"relu": (torch.relu,), "tanh": (F.tanh,),
            "sigmoid": (F.sigmoid,)}
_NAMED_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _named_classes():
  # Deferred: the projection networks' module imports this one's siblings.
  from agents_tpu_torch.networks import projection_networks as pn
  return {
      "NormalProjection": pn.NormalProjection,
      "TanhNormalProjection": pn.TanhNormalProjection,
      "CategoricalProjection": pn.CategoricalProjection,
  }


def _encode_value(v):
  """The JSON-encodable form of v; raises TypeError if there is none."""
  for name, fn in _NAMED_VALUES.items():
    if v is fn or any(v is alias for alias in _ALIASES.get(name, ())):
      return {"__named__": name}
  for name, dt in _NAMED_DTYPES.items():
    if v is dt:
      return {"__dtype__": name}
  for name, cls in _named_classes().items():
    if v is cls:
      return {"__class__": name}
  json.dumps(v)  # raises TypeError if not representable
  return v


def _decode_value(v):
  if isinstance(v, dict):
    if "__named__" in v:
      return _NAMED_VALUES[v["__named__"]]
    if "__dtype__" in v:
      return _NAMED_DTYPES[v["__dtype__"]]
    if "__class__" in v:
      return _named_classes()[v["__class__"]]
  return v


def register_factory(fn: Callable) -> Callable:
  """Decorator: registers `fn` and stamps the networks it returns with a
  rebuildable ``build_config`` (None when an argument is not
  representable)."""

  @functools.wraps(fn)
  def wrapper(*args, **kwargs):
    net = fn(*args, **kwargs)
    try:
      bound = inspect.signature(fn).bind(*args, **kwargs)
      cfg = {name: _encode_value(val)
             for name, val in bound.arguments.items()
             if name not in _UNRECORDED}
      net.build_config = {"factory": fn.__name__, "kwargs": cfg}
    except TypeError:
      net.build_config = None  # unrepresentable argument; explicit load only
    return net

  # The registry holds the wrapped version, so nested factory calls
  # (make_sac_actor_network -> make_actor_distribution_network) and
  # build_network() go through the same stamping.
  FACTORY_REGISTRY[fn.__name__] = wrapper
  return wrapper


def build_network(config: dict, observation_spec, action_spec=None,
                  device="cuda"):
  """Rebuild a network on `device` from its ``build_config`` and the
  manifest's specs."""
  factory = FACTORY_REGISTRY.get(config["factory"])
  if factory is None:
    raise KeyError(
        f"Unknown network factory '{config['factory']}'. Registered: "
        f"{sorted(FACTORY_REGISTRY)}")
  sig = inspect.signature(factory)
  call_kwargs = {}
  for name in sig.parameters:
    if name in ("input_spec", "observation_spec"):
      call_kwargs[name] = observation_spec
    elif name == "action_spec":
      if action_spec is None:
        raise ValueError(f"{config['factory']} needs an action_spec")
      call_kwargs[name] = action_spec
    elif name == "device":
      call_kwargs[name] = device
  for name, val in config.get("kwargs", {}).items():
    call_kwargs[name] = _decode_value(val)
  return factory(**call_kwargs)
