"""QT-Opt's grasping Q-function: an image-and-action conv critic.

Kalashnikov et al. 2018, "QT-Opt: Scalable Deep Reinforcement Learning
for Vision-Based Robotic Manipulation" (arXiv:1806.10293), the figure of
the Q-function and section 4; its image stack is that of Levine et al.
2016 (arXiv:1603.02199). The input is an observation nest with a uint8
image ``[H, W, 3]`` (472 x 472 in the paper) and a vector state (the
gripper's status and height), and an action vector (8 floats in QT-Opt:
a Cartesian displacement, the sine and cosine of a vertical rotation,
and a one-hot of close gripper, open gripper and terminate):

  torso  the image scaled by 1/255; Conv(64, 6x6, stride 2) unpadded,
         ReLU, MaxPool(3x3, stride 3); six Conv(64, 5x5) padded as XLA's
         SAME, ReLU; MaxPool(3x3, stride 3): 472 -> 234 -> 78 -> 26.
  merge  the action and the state concatenated, Dense 256 and Dense 64
         (ReLU after each), added to every position of the torso's
         26 x 26 x 64 map.
  head   six Conv(64, 3x3) SAME, ReLU; MaxPool(2x2, stride 2) to 13 x 13;
         three Conv(64, 3x3) SAME, ReLU; Dense 64 and Dense 64 (ReLU) over
         the flattened map; Dense 1: the logit of Q in [0, 1].

The action enters only after the torso, so a caller that scores many
actions per observation (the cross-entropy method,
``policies/cem_policy.py``) runs `features` once per observation and
`head` over ``[N, B]`` candidate actions on those features: the features
are broadcast against the candidates in the merge's add, never copied per
candidate before it. `forward` is ``head(features(observation))``, the
critic convention ``((observation, action), step_type, state)``, and
returns the logit (`QtOptAgent(q_logits=True)` reads Q as its sigmoid).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import (Network, cast_linear,
                                               seeded_generator,
                                               uniform_symmetric_,
                                               variance_scaling_)
from agents_tpu_torch.networks.registry import register_factory
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device

# The published layers: (filters, kernel, stride) per conv; the pools as
# (after conv layer, kernel, stride).
GRASP_TORSO = ((64, 6, 2),) + ((64, 5, 1),) * 6
GRASP_TORSO_PADDING = ("VALID",) + ("SAME",) * 6
GRASP_TORSO_POOLS = ((0, 3, 3), (6, 3, 3))
GRASP_MERGE = (256, 64)
GRASP_HEAD = ((64, 3, 1),) * 9
GRASP_HEAD_POOLS = ((5, 2, 2),)
GRASP_HEAD_FC = (64, 64)


def _pools(pools) -> dict:
  return {layer: (kernel, stride) for layer, kernel, stride in pools}


class GraspQModule(Network):
  """QT-Opt's grasping critic: logit of Q(observation, action).

  Args:
    input_spec: ``(observation_spec, action_spec)``; the observation a
      dict with the image ``[H, W, C]`` uint8 under `image_key` and the
      vector state under `state_key`.
    torso_conv_layer_params, torso_padding, torso_max_pools: the torso's
      convs, their paddings ("SAME" or "VALID", one each) and pools
      ((after layer, kernel, stride) each).
    merge_fc_layer_params: the Dense widths over (action, state); the
      last is the torso's channel count.
    head_conv_layer_params, head_max_pools, head_fc_layer_params: the
      head's SAME convs, pools and Dense widths before the logit.
  """

  def __init__(self, input_spec,
               torso_conv_layer_params=GRASP_TORSO,
               torso_padding: Sequence[str] = GRASP_TORSO_PADDING,
               torso_max_pools=GRASP_TORSO_POOLS,
               merge_fc_layer_params: Sequence[int] = GRASP_MERGE,
               head_conv_layer_params=GRASP_HEAD,
               head_max_pools=GRASP_HEAD_POOLS,
               head_fc_layer_params: Sequence[int] = GRASP_HEAD_FC,
               image_key: str = "image", state_key: str = "state",
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec)
    device = resolve_device(device)
    observation_spec, action_spec = input_spec
    image_spec = observation_spec[image_key]
    self.image_key, self.state_key = image_key, state_key
    self.activation = activation
    self.dtype = dtype
    convs = tuple(tuple(c) for c in torso_conv_layer_params)
    self.torso = EncoderModule(
        {image_key: image_spec}, convs, (), activation, dtype=dtype,
        preprocessing=lambda x: x.to(dtype) / 255.0, device=device,
        generator=generator, padding=tuple(torso_padding),
        max_pools=_pools(torso_max_pools))
    channels = convs[-1][0]
    size = math.isqrt(self.torso.output_size // channels)  # square images
    self.map_shape: Tuple[int, int, int] = (channels, size, size)
    if tuple(merge_fc_layer_params)[-1:] != (channels,):
      raise ValueError(f"the merge's last width must be the torso's "
                       f"{channels} channels, got {merge_fc_layer_params}")
    width = sum(int(np.prod(s.shape)) for s in nest_utils.flatten(
        action_spec, is_leaf=array_spec._is_spec))
    width += int(np.prod(observation_spec[state_key].shape))
    self.merge = nn.ModuleList()
    for out in merge_fc_layer_params:
      layer = nn.utils.skip_init(nn.Linear, width, out, device=device)
      variance_scaling_(layer.weight, generator=generator)
      nn.init.zeros_(layer.bias)
      self.merge.append(layer)
      width = out
    self.head_stack = EncoderModule(
        array_spec.ArraySpec((size, size, channels), np.float32, "map"),
        tuple(tuple(c) for c in head_conv_layer_params),
        tuple(head_fc_layer_params), activation, dtype=dtype, device=device,
        generator=generator, max_pools=_pools(head_max_pools))
    self.logit = nn.utils.skip_init(nn.Linear, self.head_stack.output_size,
                                    1, device=device)
    uniform_symmetric_(self.logit.weight, 0.003, generator)
    nn.init.zeros_(self.logit.bias)

  def features(self, observation) -> torch.Tensor:
    """The torso's ``[B, C, H, W]`` map of the observation's images."""
    image = self.torso.preprocessing(observation[self.image_key])
    return self.torso.conv_map(image.to(self.dtype))

  def head(self, features: torch.Tensor, action,
           observation) -> torch.Tensor:
    """Logits ``[N, B]`` of candidate actions ``[N, B, A]`` (or ``[B]``
    of ``[B, A]``) on the rows' `features` ``[B, C, H, W]``; each row's
    vector state is read from `observation`."""
    action = torch.cat([a.to(self.dtype) for a in nest_utils.flatten(
        action)], dim=-1)
    lead = tuple(action.shape[:-1])
    state = observation[self.state_key].to(self.dtype)
    x = torch.cat([action, state.expand(lead + state.shape[-1:])], dim=-1)
    for layer in self.merge:
      x = self.activation(cast_linear(x, layer, self.dtype))
    x = features + x[..., None, None]              # [*lead, C, H, W]
    x, _ = self.head_stack(
        x.reshape((-1,) + self.map_shape).permute(0, 2, 3, 1))
    return cast_linear(x, self.logit, self.dtype)[:, 0].reshape(lead)

  def forward(self, observation_and_action, step_type=None,
              network_state=()):
    observation, action = observation_and_action
    return self.head(self.features(observation), action,
                     observation), network_state


@register_factory
def make_grasp_q_network(input_spec,
                         torso_conv_layer_params=GRASP_TORSO,
                         torso_padding=GRASP_TORSO_PADDING,
                         torso_max_pools=GRASP_TORSO_POOLS,
                         merge_fc_layer_params=GRASP_MERGE,
                         head_conv_layer_params=GRASP_HEAD,
                         head_max_pools=GRASP_HEAD_POOLS,
                         head_fc_layer_params=GRASP_HEAD_FC,
                         dtype: torch.dtype = torch.float32, device="cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> GraspQModule:
  """A `GraspQModule` on `device` at the published widths unless given,
  initialised from `generator` (seeded 0 on the device when None)."""
  device = resolve_device(device)
  return GraspQModule(
      input_spec, torso_conv_layer_params, torso_padding, torso_max_pools,
      merge_fc_layer_params, head_conv_layer_params, head_max_pools,
      head_fc_layer_params, dtype=dtype, device=device,
      generator=seeded_generator(device, generator))
