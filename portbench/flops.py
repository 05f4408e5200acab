"""Frozen operation and byte counts, and the table of peaks.

Counts are analytic, from the configuration's shapes, 2 FLOPs per
multiply-add. `conv_forward_flops` and `conv_iteration_flops` are copies
of ``bench_torch.py:239-261`` (which count as ``bench.py:236-254``);
`sac_train_step_flops` is a copy of ``chip_smoke.py:2520-2538``. The
peaks are NVIDIA's published ones for one H100 SXM, dense, at its full
700 W limit.

A roofline's least time counts each input of an operation read once and
each output written once, in the operation's own precision, and takes the
larger of FLOPs over peak and bytes over bandwidth, summed over the
operations.
"""
from __future__ import annotations

PEAKS = {
    "bf16_dense": 989e12,      # tensor cores, bfloat16 and float16
    "tf32_dense": 495e12,
    "fp32": 67e12,             # float32 outside the tensor cores
    "fp8_dense": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12


def conv_forward_flops(size, frames, num_actions, convs, fc):
  """FLOPs of one Q-network forward on one frame stack: SAME padding,
  ceil(dim / stride) outputs."""
  total, cin = 0, frames
  for filters, kernel, stride in convs:
    size = -(-size // stride)
    total += size * size * filters * kernel * kernel * cin * 2
    cin = filters
  width = size * size * cin
  for out in tuple(fc) + (num_actions,):
    total += width * out * 2
    width = out
  return total


def conv_iteration_flops(size, frames, num_actions, batch_rows, sample,
                         convs, fc):
  """Model FLOPs of one fused DQN iteration: the collect forward on the B
  rows; the train step's online forward, backward and target forward on
  the S windows. The backward is taken as twice the forward, which
  counts the first convolution's input gradient that autograd never
  computes (its input needs no gradient): an overcount of
  ``2 * S * (first convolution's forward FLOPs)``, kept so the count
  stays the one `bench_torch.py`'s `mfu` uses."""
  fwd = conv_forward_flops(size, frames, num_actions, convs, fc)
  return fwd * (batch_rows + 4 * sample)


def sac_train_step_flops(sample_batch_size, obs_dim, act_dim, actor_fc,
                         critic_fc):
  """FLOPs of one SAC train step. Per sampled row, with A and C one actor
  and one critic forward: the critic targets take the actor and two
  target critics (A + 2C); the critic loss two critic forwards and their
  backward, about twice the forward (2C + 4C); the actor loss the actor
  and two critics forward (A + 2C), the critics' backward to the actions
  (2C) and the actor's backward (2A). In all 4A + 12C."""
  def macs(width, widths):
    total = 0
    for out in widths:
      total += width * out
      width = out
    return total

  a = macs(obs_dim, tuple(actor_fc) + (2 * act_dim,))
  c = macs(obs_dim + act_dim, tuple(critic_fc) + (1,))
  return 2 * sample_batch_size * (4 * a + 12 * c)


def _bound(flops, nbytes, peak):
  return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def conv_least_seconds(size, frames, convs, batch_rows, sample, elem_bytes,
                       peak):
  """Least time of one fused DQN iteration's convolution work: forward on
  the B collect rows; on the S sampled rows the online forward, its input
  gradient (not the first convolution's, whose input needs none) and its
  weight and bias gradient, and the target forward."""
  layers, cin = [], frames
  for filters, kernel, stride in convs:
    out = -(-size // stride)
    layers.append((size * size * cin, out * out * filters,
                   filters * cin * kernel * kernel, filters,
                   out * out * filters * kernel * kernel * cin * 2))
    size, cin = out, filters
  total = 0.0
  for i, (x, y, w, b, flops) in enumerate(layers):
    for rows in (batch_rows, sample, sample):           # collect, online,
      total += _bound(rows * flops,                     # target forward
                      elem_bytes * (rows * (x + y) + w + b), peak)
    total += _bound(sample * flops,                     # weight gradient
                    elem_bytes * (sample * (x + y) + w + b), peak)
    if i > 0:                                           # input gradient
      total += _bound(sample * flops, elem_bytes * (sample * (x + y) + w),
                      peak)
  return total


def dense_least_seconds(gemms, elem_bytes, peak):
  """Least time of `gemms`, each (rows, in, out, kind) with kind
  "forward" (x and the weight and bias in, y out), "weight" (dy and x in,
  the weight out) or "input" (dy and the weight in, dx out)."""
  total = 0.0
  for rows, n_in, n_out, kind in gemms:
    flops = 2 * rows * n_in * n_out
    if kind == "forward":
      nbytes = rows * n_in + n_in * n_out + n_out + rows * n_out
    elif kind == "weight":
      nbytes = rows * n_out + rows * n_in + n_in * n_out
    elif kind == "input":
      nbytes = rows * n_out + n_in * n_out + rows * n_in
    else:
      raise ValueError(f"unknown GEMM kind {kind!r}")
    total += _bound(flops, elem_bytes * nbytes, peak)
  return total


def _layers(sizes):
  return list(zip(sizes[:-1], sizes[1:]))


def sac_step_gemms(sample, obs_dim, act_dim, actor_fc, critic_fc):
  """The dense layers' GEMMs of one SAC train step: the actor forward on
  s' and s; six critic forwards (the two targets on s' and a', the
  critic loss's two on the replay's actions, the actor loss's two on the
  actor's); the critic loss's backward into both critics' weights
  and, past each first layer, their inputs; the actor loss's backward
  through both critics to the actions (inputs only) and into the actor's
  weights and, past its first layer, its inputs."""
  actor = _layers((obs_dim,) + tuple(actor_fc) + (2 * act_dim,))
  critic = _layers((obs_dim + act_dim,) + tuple(critic_fc) + (1,))
  gemms = []
  for _ in range(2):
    gemms += [(sample, i, o, "forward") for i, o in actor]
  for _ in range(6):
    gemms += [(sample, i, o, "forward") for i, o in critic]
  for _ in range(2):
    gemms += [(sample, i, o, "weight") for i, o in critic]
    gemms += [(sample, i, o, "input") for i, o in critic[1:]]
  for _ in range(2):
    gemms += [(sample, i, o, "input") for i, o in critic]
  gemms += [(sample, i, o, "weight") for i, o in actor]
  gemms += [(sample, i, o, "input") for i, o in actor[1:]]
  return gemms
