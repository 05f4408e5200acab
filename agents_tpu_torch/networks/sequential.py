"""Network combinators: a sequential chain, a nest map, and small layers.

Port of ``agents_tpu/networks/sequential.py``:
  - `SequentialModule` / `sequential` chain layers. A layer whose call
    takes three positional arguments (an `nn.Module`'s `forward` is read)
    follows the network convention ``(x, step_type, state) -> (x, state)``
    and gets its own slot of the chain's state tuple; any other layer is
    called on ``x`` alone and keeps the state ``()``. The dispatch reads
    the signature, so a `TypeError` raised inside a layer propagates.
  - `NestMapModule` applies a nest of modules leaf by leaf to a nest of
    inputs.
  - `inner_reshape` reshapes the trailing dims and keeps every outer dim.
  - `BiasLayer` adds a learned bias, zero at start.
  - `mask_splitter` returns an ``observation -> (network observation,
    mask)`` splitter for the Q policies and agents.

The chain and the map hold modules that already live on a device; the
bias layer, which owns a parameter, takes the device itself.
"""
from __future__ import annotations

import inspect
from typing import Any, Sequence

import torch
from torch import nn

from agents_tpu_torch.networks.network import Network
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def _takes_state(layer) -> bool:
  fn = layer.forward if isinstance(layer, nn.Module) else layer
  try:
    params = inspect.signature(fn).parameters.values()
  except (TypeError, ValueError):
    return True  # no signature to read: assume the full convention
  if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
    return True
  positional = [p for p in params
                if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                              inspect.Parameter.POSITIONAL_OR_KEYWORD)
                and p.name != "self"]
  return len(positional) >= 3


class SequentialModule(Network):
  """Chains `layers`; the state is a tuple with one entry per layer."""

  def __init__(self, layers: Sequence[Any], input_spec=None, state_spec=()):
    super().__init__(input_spec, state_spec)
    self.layers = tuple(layers)
    for i, layer in enumerate(self.layers):
      if isinstance(layer, nn.Module):
        self.add_module(f"layer_{i}", layer)

  def forward(self, inputs, step_type=None, network_state=()):
    x = inputs
    n = len(self.layers)
    states = (list(network_state) if isinstance(network_state, (list, tuple))
              and len(network_state) == n else [()] * n)
    new_states = []
    for layer, st in zip(self.layers, states):
      if _takes_state(layer):
        out = layer(x, step_type, st)
        x, st_new = out if isinstance(out, tuple) and len(out) == 2 \
            else (out, ())
      else:
        x, st_new = layer(x), ()
      new_states.append(st_new)
    return x, tuple(new_states)


def sequential(layers, input_spec, state_spec=()) -> SequentialModule:
  return SequentialModule(layers, input_spec, state_spec)


def _is_module(m) -> bool:
  return isinstance(m, nn.Module)


class NestMapModule(Network):
  """Applies a nest of modules leaf-wise to a matching nest of inputs."""

  def __init__(self, modules, input_spec=None, state_spec=()):
    super().__init__(input_spec, state_spec)
    self.module_nest = modules
    for i, m in enumerate(nest_utils.flatten(modules, is_leaf=_is_module)):
      self.add_module(f"module_{i}", m)

  def forward(self, inputs, step_type=None, network_state=()):
    return nest_utils.tree_map(lambda m, x: m(x), self.module_nest, inputs,
                               is_leaf=_is_module), network_state


def inner_reshape(inner_shape, inner_rank: int = 1):
  """Reshape the trailing `inner_rank` dims to `inner_shape`, keeping all
  outer dims (a [B, T, 16] input with inner shape (4, 4) becomes [B, T, 4,
  4])."""

  def fn(x):
    return x.reshape(tuple(x.shape[:x.dim() - inner_rank])
                     + tuple(inner_shape))

  return fn


class BiasLayer(nn.Module):
  """A learned bias over the last dim of `features` entries, zero at
  start."""

  def __init__(self, features: int, device="cuda"):
    super().__init__()
    self.bias = nn.Parameter(torch.zeros(features,
                                         device=resolve_device(device)))

  def forward(self, x):
    return x + self.bias


def mask_splitter(splitter_fn):
  """An ``observation -> (network observation, mask)`` splitter."""
  return splitter_fn
