"""Recurrent networks: an LSTM encoder that resets its carry on FIRST steps.

Port of ``agents_tpu/networks/lstm_networks.py`` (:31-214). The encoder is

    input Dense stack (time-parallel over ``[B*T, F]``)
    -> masked LSTM cell, one Python step per time index
    -> output Dense stack (time-parallel)

and takes one step ``[B, ...]`` or a sequence ``[B, T, ...]``: a 2-D
`step_type` means a sequence, anything else one step (:64-73). The carry
is ``(c, h)``, each ``[B, lstm_size]``; a `network_state` of None or ()
starts from zeros (:75-78). Where a step is FIRST, the carry is multiplied
by ``1 - first`` before the cell update, so no episode sees the state of
the one before it (:31-43).

The cell is flax's `OptimizedLSTMCell`: gates i, f, g, o from
``x W_i + h W_h + b_h``; ``c' = sigmoid(f) c + sigmoid(i) tanh(g)`` and
``h' = sigmoid(o) tanh(c')``. The four input kernels are one ``[4H, in]``
Linear without bias (`lstm_input`), the four recurrent kernels one
``[4H, H]`` Linear with the bias (`lstm_hidden`), gate blocks in the order
i, f, g, o. `torch.nn.LSTM` and cuDNN's LSTM cannot reset the carry per
row and step, so the cell is written out here.

The input products of every step, with the bias, are one product before
the time loop. The loop itself is `_MaskedLSTMUnroll`, an autograd
function whose backward is written out (backpropagation through time:
seven device ops a step, the recurrent weight's gradient one product over
all steps): left to autograd, each step's graph took about four times the
ops, and the train step of a recurrent PPO minibatch is nothing but such
steps, each op a host dispatch. On a CUDA tensor each time step of the
forward and of the backward is instead one launch of a hand-written
kernel (`ops/lstm_recurrence.py`, float32 only); the Python loop is the
plain version, which runs on the CPU and under `torch.export` (an
exported artifact's loader imports only numpy and torch, so it cannot
carry the kernel).

Initializers are flax's: the Dense layers and the input kernels
`lecun_normal_`, each recurrent ``[H, H]`` block orthogonal, zero biases;
the Q head U(±0.03) with bias -0.2, the value head `lecun_normal_`.

`RecurrentDuelingQModule` is R2D2's network (Kapturowski et al. 2019,
"Recurrent Experience Replay in Distributed Reinforcement Learning",
section 2 and appendix): an `EncoderModule` conv torso and its fc layer,
whose output is concatenated with the one-hot previous action and the
previous reward (both zero at a FIRST step, as the carry is), then the
masked LSTM, then dueling value and advantage streams of one hidden layer
each, ``Q = V + A - mean(A)``. Its state spec is the carry ``(c, h)``;
the previous action and reward come in as inputs.

Spans (`utils/profiling.py`): ``lstm.unroll`` around the forward time
loop, ``lstm.backward`` around the written-out backward; the counter
``lstm.steps`` adds the time steps of each forward unroll,
``lstm.kernel_steps`` those of each forward unroll that ran the kernel, and
``lstm.backward_steps`` those of each backward.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import (Network, cast_linear,
                                               lecun_normal_,
                                               seeded_generator)
from agents_tpu_torch.networks.projection_networks import (NormalProjection,
                                                           default_projection)
from agents_tpu_torch.networks.q_network import _head, num_actions
from agents_tpu_torch.networks.registry import register_factory
from agents_tpu_torch.ops.lstm_recurrence import KERNEL
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils, profiling
from agents_tpu_torch.utils.device import resolve_device

_UNROLL = profiling.annotate("lstm.unroll")
_BACKWARD = profiling.annotate("lstm.backward")


def _dense(width: int, out: int, device, generator) -> nn.Linear:
  """flax's default Dense: `lecun_normal_` kernel, zero bias."""
  layer = nn.utils.skip_init(nn.Linear, width, out, device=device)
  lecun_normal_(layer.weight, generator)
  nn.init.zeros_(layer.bias)
  return layer


def _is_empty(state) -> bool:
  return state is None or (isinstance(state, tuple) and len(state) == 0)


def _on_kernel(x) -> bool:
  """Whether an unroll of `x` runs the CUDA kernel: a CUDA tensor, outside
  `torch.export`'s tracing."""
  return x.is_cuda and not torch.compiler.is_exporting()


class _MaskedLSTMUnroll(torch.autograd.Function):
  """The reset-masked LSTM over T steps, with its backward written out.

  forward(gates_x [B, T, 4H] (the input products and the bias), keep
  [B, T] (0 where the step is FIRST), w_h [4H, H], c [B, H], h [B, H],
  save) -> (outputs [B, T, H], final c, final h).

  On a CUDA tensor (float32, else it raises) the kernel runs each step, and
  keeps what the backward needs only where `save` says a gradient is
  needed: grad mode is off inside `forward`, so the caller decides. On the
  CPU and under `torch.export` the plain Python loop below runs.
  """

  @staticmethod
  def forward(ctx, gates_x, keep, w_h, c, h, save=True):
    with _UNROLL:
      ctx.kernel = _on_kernel(gates_x)
      if ctx.kernel:
        profiling.count("lstm.steps", gates_x.shape[1])
        profiling.count("lstm.kernel_steps", gates_x.shape[1])
        y, c, h, ctx.steps = KERNEL.forward(gates_x, keep, w_h, c, h, save)
        ctx.save_for_backward(keep, w_h)
        return y, c, h
      return _MaskedLSTMUnroll._forward(ctx, gates_x, keep, w_h, c, h)

  @staticmethod
  def _forward(ctx, gates_x, keep, w_h, c, h):
    profiling.count("lstm.steps", gates_x.shape[1])
    size = w_h.shape[1]
    w_t = w_h.t()
    keeps = keep.t().unsqueeze(-1).unbind(0)                   # T x [B, 1]
    acts, tanh_gs, cells, hiddens, tanh_cs, outputs = [], [], [], [], [], []
    for k, gx in zip(keeps, gates_x.unbind(1)):
      c, h = c * k, h * k
      cells.append(c)
      hiddens.append(h)
      gates = torch.addmm(gx, h, w_t)
      act = torch.sigmoid(gates)
      g = torch.tanh(gates[:, 2 * size:3 * size])
      i, f, _, o = act.chunk(4, dim=1)
      c = torch.addcmul(f * c, i, g)
      tanh_c = torch.tanh(c)
      h = o * tanh_c
      acts.append(act)
      tanh_gs.append(g)
      tanh_cs.append(tanh_c)
      outputs.append(h)
    ctx.save_for_backward(keep, w_h)
    ctx.steps = (acts, tanh_gs, cells, hiddens, tanh_cs)
    return torch.stack(outputs, dim=1), c, h

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, d_outputs, d_c, d_h):
    with _BACKWARD:
      profiling.count("lstm.backward_steps", d_outputs.shape[1])
      if ctx.kernel:
        keep, w_h = ctx.saved_tensors
        d_gates, d_w, d_c, d_h = KERNEL.backward(d_outputs, d_c, d_h, keep,
                                                 w_h, ctx.steps)
        return d_gates, None, d_w, d_c, d_h, None
      return _MaskedLSTMUnroll._backward(ctx, d_outputs, d_c, d_h) + (None,)

  @staticmethod
  def _backward(ctx, d_outputs, d_c, d_h):
    keep, w_h = ctx.saved_tensors
    acts, tanh_gs, cells, hiddens, tanh_cs = (torch.stack(x)
                                              for x in ctx.steps)
    i, f, _, o = acts.chunk(4, dim=-1)                         # [T, B, H]
    # d gates = [dc, dc, dc, dh] * coef, per gate block i, f, g, o.
    coef = torch.cat([tanh_gs * i * (1 - i), cells * f * (1 - f),
                      i * (1 - tanh_gs * tanh_gs),
                      tanh_cs * o * (1 - o)], dim=-1).unbind(0)
    o_dtanh = (o * (1 - tanh_cs * tanh_cs)).unbind(0)
    keeps = keep.t().unsqueeze(-1)
    f_keep = (f * keeps).unbind(0)
    keeps = keeps.unbind(0)
    d_out = d_outputs.transpose(0, 1).unbind(0)
    d_gates = [None] * len(d_out)
    for t in reversed(range(len(d_out))):
      d_h = d_h + d_out[t]
      d_c = torch.addcmul(d_c, d_h, o_dtanh[t])
      d_gates[t] = torch.cat([d_c, d_c, d_c, d_h], dim=1) * coef[t]
      d_h = torch.mm(d_gates[t], w_h) * keeps[t]
      d_c = d_c * f_keep[t]
    d_gates = torch.stack(d_gates)                             # [T, B, 4H]
    d_w = d_gates.flatten(0, 1).t().mm(hiddens.flatten(0, 1))
    return d_gates.transpose(0, 1), None, d_w, d_c, d_h


class LSTMEncoder(nn.Module):
  """Input Dense stack -> reset-masked LSTM -> output Dense stack.

  Args:
    input_spec: the observation spec nest (its leaves are flattened past
      the batch, or batch and time, dims and concatenated).
    input_fc_layer_params / output_fc_layer_params: Dense widths before
      and after the LSTM.
    lstm_size: H, the width of the carry.
  """

  def __init__(self, input_spec, input_fc_layer_params: Sequence[int] = (40,),
               lstm_size: int = 40,
               output_fc_layer_params: Sequence[int] = (40,),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    self.activation = activation
    self.dtype = dtype
    self.lstm_size = lstm_size
    width = sum(int(np.prod(s.shape)) for s in nest_utils.flatten(
        input_spec, is_leaf=array_spec._is_spec))
    self.input_layers = nn.ModuleList()
    for out in input_fc_layer_params:
      self.input_layers.append(_dense(width, out, device, generator))
      width = out
    self.lstm_input = nn.utils.skip_init(nn.Linear, width, 4 * lstm_size,
                                         bias=False, device=device)
    lecun_normal_(self.lstm_input.weight, generator)
    self.lstm_hidden = nn.utils.skip_init(nn.Linear, lstm_size,
                                          4 * lstm_size, device=device)
    with torch.no_grad():
      for block in self.lstm_hidden.weight.split(lstm_size):
        nn.init.orthogonal_(block, generator=generator)
    nn.init.zeros_(self.lstm_hidden.bias)
    width = lstm_size
    self.output_layers = nn.ModuleList()
    for out in output_fc_layer_params:
      self.output_layers.append(_dense(width, out, device, generator))
      width = out
    self.output_size = width

  def _stack(self, x, layers):
    for layer in layers:
      x = self.activation(cast_linear(x, layer, self.dtype))
    return x

  def forward(self, observation, step_type=None, network_state=None):
    leaves = nest_utils.flatten(observation)
    batch = leaves[0].shape[0]
    has_time = step_type is not None and step_type.dim() == 2
    if step_type is None:
      step_type = torch.full((batch,), ts.StepType.MID, dtype=torch.int32,
                             device=leaves[0].device)
    if not has_time:
      leaves = [x[:, None] for x in leaves]
      step_type = step_type[:, None]
    steps = step_type.shape[1]
    if _is_empty(network_state):
      zeros = torch.zeros((batch, self.lstm_size), dtype=self.dtype,
                          device=leaves[0].device)
      network_state = (zeros, zeros)

    flat = [x.reshape(batch * steps, -1).to(self.dtype) for x in leaves]
    x = flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)
    x = self._stack(x, self.input_layers)
    gates_x = F.linear(x, self.lstm_input.weight.to(self.dtype),
                       self.lstm_hidden.bias.to(self.dtype))
    keep = (step_type != ts.StepType.FIRST).to(self.dtype)        # [B, T]
    c, h = network_state
    args = (gates_x.reshape(batch, steps, -1), keep,
            self.lstm_hidden.weight.to(self.dtype), c.to(self.dtype),
            h.to(self.dtype))
    save = torch.is_grad_enabled() and any(x.requires_grad for x in args)
    y, c, h = _MaskedLSTMUnroll.apply(*args, save)
    y = self._stack(y.reshape(batch * steps, -1), self.output_layers)
    y = y.reshape(batch, steps, -1)
    if not has_time:
      y = y[:, 0]
    return y, (c, h)


class _RnnNetwork(Network):
  """An `LSTMEncoder` with the LSTM carry as its state spec."""

  def __init__(self, input_spec, input_fc_layer_params, lstm_size,
               output_fc_layer_params, dtype, device, generator):
    super().__init__(input_spec, state_spec=_lstm_state_spec(lstm_size))
    self.dtype = dtype
    self.encoder = LSTMEncoder(input_spec, input_fc_layer_params, lstm_size,
                               output_fc_layer_params, dtype=dtype,
                               device=device, generator=generator)


class QRnnModule(_RnnNetwork):
  """LSTM encoder, then one Q value per action (float32)."""

  def __init__(self, input_spec, num_actions: int,
               input_fc_layer_params=(40,), lstm_size: int = 40,
               output_fc_layer_params=(40,),
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    device = resolve_device(device)
    super().__init__(input_spec, input_fc_layer_params, lstm_size,
                     output_fc_layer_params, dtype, device, generator)
    self.q_head = _head(self.encoder.output_size, num_actions, -0.2, device,
                        generator)

  def forward(self, observation, step_type=None, network_state=None):
    y, state = self.encoder(observation, step_type, network_state)
    return cast_linear(y, self.q_head, self.dtype).float(), state


class ValueRnnModule(_RnnNetwork):
  """LSTM encoder, then one value per row (and step), float32."""

  def __init__(self, input_spec, input_fc_layer_params=(40,),
               lstm_size: int = 40, output_fc_layer_params=(40,),
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    device = resolve_device(device)
    super().__init__(input_spec, input_fc_layer_params, lstm_size,
                     output_fc_layer_params, dtype, device, generator)
    self.value_head = _dense(self.encoder.output_size, 1, device, generator)

  def forward(self, observation, step_type=None, network_state=None):
    y, state = self.encoder(observation, step_type, network_state)
    v = cast_linear(y, self.value_head, self.dtype)
    return v.squeeze(-1).float(), state


class ActorDistributionRnnModule(_RnnNetwork):
  """LSTM encoder, then one `default_projection` head per action leaf."""

  def __init__(self, input_spec, action_spec, input_fc_layer_params=(40,),
               lstm_size: int = 40, output_fc_layer_params=(40,),
               continuous_projection=NormalProjection,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    device = resolve_device(device)
    super().__init__(input_spec, input_fc_layer_params, lstm_size,
                     output_fc_layer_params, dtype, device, generator)
    self.action_spec = action_spec
    self.projections = nn.ModuleList(
        default_projection(self.encoder.output_size, spec,
                           continuous_projection, dtype=dtype, device=device,
                           generator=generator)
        for spec in nest_utils.flatten(action_spec,
                                       is_leaf=array_spec._is_spec))

  def forward(self, observation, step_type=None, network_state=None):
    y, state = self.encoder(observation, step_type, network_state)
    dists = iter([projection(y) for projection in self.projections])
    return nest_utils.tree_map(lambda _: next(dists), self.action_spec,
                               is_leaf=array_spec._is_spec), state


class RecurrentDuelingQModule(Network):
  """R2D2's Q network: conv torso and fc, then with the one-hot previous
  action and the previous reward the masked LSTM, then dueling streams
  (see the module docstring). Float32 Q values ``[B, A]`` of one step, or
  ``[B, T, A]`` of a sequence (a 2-D `step_type`).

  Args:
    input_spec: the frame spec ``[H, W, C]``.
    num_actions: A.
    conv_layer_params: (filters, kernel, stride) of the torso.
    fc_layer_params: the torso's Dense widths after the convolutions.
    lstm_size: H, the width of the carry.
    dueling_fc_layer_params: the hidden widths of each stream.
    preprocessing: applied to the frames first (e.g. scaling by 1/255).

  The torso's convolutions are unpadded ("VALID"), as published.
  """

  def __init__(self, input_spec, num_actions: int,
               conv_layer_params=((32, 8, 4), (64, 4, 2), (64, 3, 1)),
               fc_layer_params: Sequence[int] = (512,),
               lstm_size: int = 512,
               dueling_fc_layer_params: Sequence[int] = (512,),
               dtype: torch.dtype = torch.float32,
               preprocessing: Optional[Callable] = None, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec, state_spec=_lstm_state_spec(lstm_size))
    device = resolve_device(device)
    self.dtype = dtype
    self.num_actions = num_actions
    self.torso = EncoderModule(input_spec, conv_layer_params,
                               fc_layer_params, dtype=dtype,
                               preprocessing=preprocessing, device=device,
                               generator=generator, padding="VALID")
    width = self.torso.output_size + num_actions + 1
    self.core = LSTMEncoder(
        (array_spec.ArraySpec((width,), np.float32, "core_input"),),
        input_fc_layer_params=(), lstm_size=lstm_size,
        output_fc_layer_params=(), dtype=dtype, device=device,
        generator=generator)
    self.value_layers, self.advantage_layers = nn.ModuleList(), \
        nn.ModuleList()
    for layers in (self.value_layers, self.advantage_layers):
      width = lstm_size
      for out in dueling_fc_layer_params:
        layers.append(_dense(width, out, device, generator))
        width = out
    self.value_head = _head(width, 1, -0.2, device, generator)
    self.advantage_head = _head(width, num_actions, -0.2, device, generator)

  def _stream(self, y, layers, head):
    for layer in layers:
      y = F.relu(cast_linear(y, layer, self.dtype))
    return cast_linear(y, head, self.dtype)

  def forward(self, observation, step_type, network_state, previous_action,
              previous_reward):
    """(Q values, (c, h)) of frames ``[B, ...]`` or ``[B, T, ...]``, with
    `step_type`, `previous_action` and `previous_reward` ``[B]`` or
    ``[B, T]``; a `network_state` of None starts from zeros."""
    outer = tuple(step_type.shape)
    frames = observation.reshape((-1,) + tuple(
        observation.shape[len(outer):]))
    x, _ = self.torso(frames)
    x = x.reshape(outer + (-1,))
    keep = (step_type != ts.StepType.FIRST).to(self.dtype)[..., None]
    one_hot = F.one_hot(previous_action.long(), self.num_actions)
    core_in = torch.cat([x, one_hot.to(self.dtype) * keep,
                         previous_reward.to(self.dtype)[..., None] * keep],
                        dim=-1)
    y, state = self.core(core_in, step_type, network_state)
    v = self._stream(y, self.value_layers, self.value_head)
    a = self._stream(y, self.advantage_layers, self.advantage_head)
    q = v + a - a.mean(dim=-1, keepdim=True)
    return q.float(), state


def _lstm_state_spec(lstm_size: int):
  """The carry's spec: ``(c, h)``, each float32 ``[lstm_size]``."""
  return (array_spec.ArraySpec((lstm_size,), np.float32, "lstm_c"),
          array_spec.ArraySpec((lstm_size,), np.float32, "lstm_h"))


@register_factory
def make_q_rnn_network(input_spec, action_spec, input_fc_layer_params=(40,),
                       lstm_size=40, output_fc_layer_params=(40,),
                       dtype: torch.dtype = torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> QRnnModule:
  """A `QRnnModule` on `device`, initialised from `generator` (a fresh
  generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  return QRnnModule(input_spec, num_actions(action_spec),
                    tuple(input_fc_layer_params), lstm_size,
                    tuple(output_fc_layer_params), dtype, device,
                    seeded_generator(device, generator))


@register_factory
def make_value_rnn_network(input_spec, input_fc_layer_params=(40,),
                           lstm_size=40, output_fc_layer_params=(40,),
                           dtype: torch.dtype = torch.float32, device="cuda",
                           generator: Optional[torch.Generator] = None
                           ) -> ValueRnnModule:
  """A `ValueRnnModule` on `device` (generator as `make_q_rnn_network`)."""
  device = resolve_device(device)
  return ValueRnnModule(input_spec, tuple(input_fc_layer_params), lstm_size,
                        tuple(output_fc_layer_params), dtype, device,
                        seeded_generator(device, generator))


@register_factory
def make_actor_distribution_rnn_network(
    input_spec, action_spec, input_fc_layer_params=(40,), lstm_size=40,
    output_fc_layer_params=(40,), continuous_projection=NormalProjection,
    dtype: torch.dtype = torch.float32, device="cuda",
    generator: Optional[torch.Generator] = None
) -> ActorDistributionRnnModule:
  """An `ActorDistributionRnnModule` on `device` (generator as
  `make_q_rnn_network`)."""
  device = resolve_device(device)
  return ActorDistributionRnnModule(
      input_spec, action_spec, tuple(input_fc_layer_params), lstm_size,
      tuple(output_fc_layer_params), continuous_projection, dtype, device,
      seeded_generator(device, generator))


@register_factory
def make_recurrent_dueling_q_network(
    input_spec, action_spec,
    conv_layer_params=((32, 8, 4), (64, 4, 2), (64, 3, 1)),
    fc_layer_params=(512,), lstm_size=512, dueling_fc_layer_params=(512,),
    dtype: torch.dtype = torch.float32,
    preprocessing: Optional[Callable] = None, device="cuda",
    generator: Optional[torch.Generator] = None) -> RecurrentDuelingQModule:
  """A `RecurrentDuelingQModule` (R2D2's network) on `device` (generator as
  `make_q_rnn_network`)."""
  device = resolve_device(device)
  return RecurrentDuelingQModule(
      input_spec, num_actions(action_spec), tuple(conv_layer_params),
      tuple(fc_layer_params), lstm_size, tuple(dueling_fc_layer_params),
      dtype, preprocessing, device,
      seeded_generator(device, generator))
