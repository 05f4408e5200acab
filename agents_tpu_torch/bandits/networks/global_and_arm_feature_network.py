"""Per-arm reward networks.

Port of ``agents_tpu/bandits/networks/global_and_arm_feature_network.py``:
`GlobalAndArmFeatureModule` (a tower over the global features and one over
each arm's features, joined per arm into a scalar reward, [B, K]) and
`HeteroscedasticQModule` (a mean and a log-variance head per action), as
`nn.Module`s with flax's Dense initializer (lecun normal, zero bias),
drawn from an explicit generator. `utils.convert` carries the JAX
package's params across.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
    GLOBAL_FEATURE_KEY, PER_ARM_FEATURE_KEY)
from agents_tpu_torch.networks.network import (Network, lecun_normal_,
                                               seeded_generator)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def dense(width_in: int, width_out: int, device, generator) -> nn.Linear:
  """A Linear initialised as flax's Dense: lecun normal, zero bias."""
  layer = nn.utils.skip_init(nn.Linear, width_in, width_out, device=device)
  lecun_normal_(layer.weight, generator)
  nn.init.zeros_(layer.bias)
  return layer


def _stack(width: int, widths: Sequence[int], device, generator):
  layers = nn.ModuleList()
  for w in widths:
    layers.append(dense(width, w, device, generator))
    width = w
  return layers, width


class GlobalAndArmFeatureModule(Network):
  """[B, K] predicted rewards from {global: [B, g], per_arm: [B, K, a]}."""

  def __init__(self, observation_spec, global_layers=(32,),
               arm_layers=(32,), common_layers=(32,),
               activation: Callable = F.relu, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(observation_spec)
    device = resolve_device(device)
    generator = seeded_generator(device, generator)
    self.activation = activation
    g = observation_spec[GLOBAL_FEATURE_KEY].shape[0]
    a = observation_spec[PER_ARM_FEATURE_KEY].shape[-1]
    # Flax numbers the Denses in this order: global, arm, common, output.
    self.global_layers, g = _stack(g, global_layers, device, generator)
    self.arm_layers, a = _stack(a, arm_layers, device, generator)
    self.common_layers, c = _stack(g + a, common_layers, device, generator)
    self.reward_head = dense(c, 1, device, generator)

  def forward(self, observation, step_type=None, network_state=()):
    g = observation[GLOBAL_FEATURE_KEY].to(torch.float32)       # [B, g]
    a = observation[PER_ARM_FEATURE_KEY].to(torch.float32)      # [B, K, a]
    for layer in self.global_layers:
      g = self.activation(layer(g))
    for layer in self.arm_layers:
      a = self.activation(layer(a))
    joint = torch.cat([g[:, None, :].expand(-1, a.shape[1], -1), a], dim=-1)
    for layer in self.common_layers:
      joint = self.activation(layer(joint))
    return self.reward_head(joint)[..., 0], network_state


def make_global_and_arm_feature_network(observation_spec,
                                        global_layers=(32,),
                                        arm_layers=(32,),
                                        common_layers=(32,), device="cuda",
                                        generator=None) -> Network:
  return GlobalAndArmFeatureModule(
      observation_spec, tuple(global_layers), tuple(arm_layers),
      tuple(common_layers), device=device, generator=generator)


class HeteroscedasticQModule(Network):
  """Mean + log-variance per action. The observation's leaves are joined
  in sorted-key order, the order of the JAX package's `tree_leaves`."""

  def __init__(self, observation_spec, num_actions: int, fc_layers=(64,),
               activation: Callable = F.relu, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(observation_spec)
    device = resolve_device(device)
    generator = seeded_generator(device, generator)
    self.activation = activation
    width = sum(int(torch.Size(s.shape).numel()) for s in
                nest_utils.flatten_sorted(observation_spec,
                                          is_leaf=array_spec._is_spec))
    self.fc_layers, width = _stack(width, fc_layers, device, generator)
    self.mean = dense(width, num_actions, device, generator)
    self.log_var = dense(width, num_actions, device, generator)

  def forward(self, observation, step_type=None, network_state=()):
    x = torch.cat([leaf.reshape(leaf.shape[0], -1).to(torch.float32)
                   for leaf in nest_utils.flatten_sorted(observation)],
                  dim=-1)
    for layer in self.fc_layers:
      x = self.activation(layer(x))
    return (self.mean(x), self.log_var(x)), network_state
