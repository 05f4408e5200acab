"""Port parity: the recurrent networks (`networks/lstm_networks.py`) against
flax's.

The LSTM encoder and the Q, value and actor RNN networks at input (8,),
LSTM 8, output (8,), from one numpy-made flax tree carried across by
`convert`: one step ``[B]`` and sequences ``[B, T]`` with FIRST steps in
the middle, from a zero and from a non-zero carry; the outputs and the new
carry within rtol 1e-5 / atol 1e-6, and the gradient of a scalar loss
against `jax.grad`. The port's initializers against flax's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch import networks as tnetworks
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import convert
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

B, T, H = 5, 6, 8
WIDTHS = dict(input_fc_layer_params=(8,), lstm_size=H,
              output_fc_layer_params=(8,))
OBS = (3,)


def _specs(continuous=False):
  if continuous:
    act = ((2,), np.float32, -1.0, 1.0)
  else:
    act = ((), np.int32, 0, 2)
  return ((jspec.ArraySpec(OBS, np.float32), jspec.BoundedArraySpec(*act)),
          (tspec.ArraySpec(OBS, np.float32), tspec.BoundedArraySpec(*act)))


def _pair(kind, seed=0, **widths):
  """(flax network, numpy-made params, port network with those params)."""
  widths = {**WIDTHS, **widths}
  continuous = kind == "actor_normal"
  (jobs, jact), (tobs, tact) = _specs(continuous)
  if kind == "q":
    jnet = jnetworks.make_q_rnn_network(jobs, jact, **widths)
    tnet = tnetworks.make_q_rnn_network(tobs, tact, **widths, device="cpu")
    to_sd = convert.q_rnn_params_to_state_dict
  elif kind == "value":
    jnet = jnetworks.make_value_rnn_network(jobs, **widths)
    tnet = tnetworks.make_value_rnn_network(tobs, **widths, device="cpu")
    to_sd = convert.value_rnn_params_to_state_dict
  else:
    jnet = jnetworks.make_actor_distribution_rnn_network(jobs, jact,
                                                         **widths)
    tnet = tnetworks.make_actor_distribution_rnn_network(tobs, tact, **widths,
                                                         device="cpu")
    to_sd = convert.actor_rnn_params_to_state_dict
  rng = np.random.RandomState(seed)
  params = jax.tree_util.tree_map(
      lambda x: rng.uniform(-0.6, 0.6, x.shape).astype(np.float32),
      jnet.init_params(jax.random.key(seed)))
  tnet.load_state_dict(to_sd(params, len(widths["input_fc_layer_params"])))
  return jnet, params, tnet


def _inputs(sequence, nonzero_carry, seed=1):
  """observation, step_type and carry: sequences have FIRST steps at
  scattered positions (t = 0 and in the middle), one step a mix of FIRST
  and MID rows."""
  rng = np.random.RandomState(seed)
  if sequence:
    obs = rng.randn(B, T, *OBS).astype(np.float32)
    step_type = np.full((B, T), ts.StepType.MID, np.int32)
    step_type[0, 0] = step_type[1, 3] = step_type[2, 5] = ts.StepType.FIRST
    step_type[3, 2] = ts.StepType.LAST
    step_type[3, 3] = ts.StepType.FIRST
  else:
    obs = rng.randn(B, *OBS).astype(np.float32)
    step_type = np.array([0, 1, 1, 2, 0], np.int32)
  carry = None
  if nonzero_carry:
    carry = tuple(rng.randn(B, H).astype(np.float32) for _ in range(2))
  return obs, step_type, carry


def _outputs(kind, out):
  """The tensors to compare of a network's output (a distribution as its
  parameters, mode and log-probability of fixed actions)."""
  if kind in ("q", "value"):
    return [out]
  if kind == "actor_categorical":
    return [out.logits, out.mode(), out.log_prob(out.mode())]
  return [out.mode(), out.log_prob(out.mode() * 0.5), out.entropy()]


def _jax_apply(jnet, params, obs, step_type, carry):
  state = None if carry is None else tuple(map(jnp.asarray, carry))
  return jnet.apply(params, jnp.asarray(obs), jnp.asarray(step_type), state)


def _torch_apply(tnet, obs, step_type, carry):
  state = None if carry is None else tuple(map(torch.from_numpy, carry))
  return tnet(torch.from_numpy(obs), torch.from_numpy(step_type), state)


KINDS = ("q", "value", "actor_categorical", "actor_normal")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sequence", [False, True], ids=["step", "sequence"])
@pytest.mark.parametrize("nonzero_carry", [False, True],
                         ids=["zero_carry", "carry"])
def test_rnn_networks_match_flax(kind, sequence, nonzero_carry):
  jnet, params, tnet = _pair(kind)
  obs, step_type, carry = _inputs(sequence, nonzero_carry)
  jout, jcarry = _jax_apply(jnet, params, obs, step_type, carry)
  with torch.no_grad():
    tout, tcarry = _torch_apply(tnet, obs, step_type, carry)
  for a, b in zip(_outputs(kind, tout), _outputs(kind, jout), strict=True):
    assert tuple(a.shape) == tuple(b.shape)
    assert_close(a, b)
  for a, b in zip(tcarry, jcarry, strict=True):
    assert tuple(a.shape) == (B, H)
    assert_close(a, b)


def test_first_step_zeroes_the_carry():
  """A FIRST step's output and carry do not depend on the carry it got."""
  _, _, tnet = _pair("q")
  obs, _, carry = _inputs(False, True)
  first = torch.zeros(B, dtype=torch.int32)
  with torch.no_grad():
    fresh = tnet(torch.from_numpy(obs), first, ())
    carried = tnet(torch.from_numpy(obs), first,
                   tuple(map(torch.from_numpy, carry)))
  assert_equal(carried[0], fresh[0])
  for a, b in zip(carried[1], fresh[1]):
    assert_equal(a, b)


@pytest.mark.parametrize("kind", ["q", "actor_categorical"])
def test_sequence_gradient_matches_jax_grad(kind):
  """d/dparams of a scalar of the unrolled outputs and the final carry, on
  sequences with mid-sequence FIRST steps from a non-zero carry."""
  jnet, params, tnet = _pair(kind, seed=2)
  obs, step_type, carry = _inputs(True, True, seed=3)
  weights = np.random.RandomState(4).randn(B, T, 3).astype(np.float32)

  def jloss(p):
    out, (c, h) = _jax_apply(jnet, p, obs, step_type, carry)
    logits = out if kind == "q" else out.logits
    return jnp.sum(logits * weights) + jnp.sum(c * h)

  jgrads = jax.grad(jloss)(params)
  out, (c, h) = _torch_apply(tnet, obs, step_type, carry)
  logits = out if kind == "q" else out.logits
  (torch.sum(logits * torch.from_numpy(weights)) + torch.sum(c * h)).backward()
  to_sd = (convert.q_rnn_params_to_state_dict if kind == "q"
           else convert.actor_rnn_params_to_state_dict)
  expected = to_sd(jax.tree_util.tree_map(np.asarray, jgrads))
  named = dict(tnet.named_parameters())
  assert list(named) == list(expected)
  for name, grad in expected.items():
    assert_close(named[name].grad, grad, err_msg=name)


def test_init_matches_flax():
  """Input kernels and Dense layers: lecun_normal (std sqrt(1 / fan_in),
  cut at 2 std); each recurrent [H, H] block orthogonal (std 1 /
  sqrt(H)); zero biases; the Q head U(±0.03) with bias -0.2 — on both
  sides, at LSTM 64."""
  (jobs, jact), (tobs, tact) = _specs()
  widths = dict(input_fc_layer_params=(64,), lstm_size=64,
                output_fc_layer_params=(64,))
  jparams = jnetworks.make_q_rnn_network(jobs, jact, **widths).init_params(
      jax.random.key(0))["params"]
  tnet = tnetworks.make_q_rnn_network(
      tobs, tact, **widths, device="cpu",
      generator=torch.Generator().manual_seed(1))
  cell = jparams["LSTMEncoderModule_0"]["Scan_MaskedLSTMCell_0"][
      "OptimizedLSTMCell_0"]
  enc = tnet.encoder

  def lecun(sample, fan_in):
    std = math.sqrt(1.0 / fan_in)
    assert abs(sample.std() / std - 1.0) < 0.1
    assert np.abs(sample).max() <= 2.0 * std / 0.87962566103423978 * (1 + 1e-6)

  lecun(np.asarray(jparams["LSTMEncoderModule_0"]["Dense_0"]["kernel"]), 3)
  lecun(enc.input_layers[0].weight.detach().numpy(), 3)
  lecun(np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in "ifgo"]),
        64)
  lecun(enc.lstm_input.weight.detach().numpy(), 64)
  lecun(enc.output_layers[0].weight.detach().numpy(), 64)
  eye = np.eye(64, dtype=np.float32)
  blocks = [np.asarray(cell[f"h{g}"]["kernel"]) for g in "ifgo"] + [
      w.detach().numpy() for w in enc.lstm_hidden.weight.split(64)]
  for block in blocks:
    assert_close(block.T @ block, eye, atol=1e-5)
    assert abs(block.std() * 8.0 - 1.0) < 0.02
  for bias in [np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"] + [
      layer.bias.detach().numpy() for layer in (
          enc.lstm_hidden, enc.input_layers[0], enc.output_layers[0])]:
    assert_equal(bias, np.zeros_like(bias))
  for head in (np.asarray(jparams["Dense_0"]["kernel"]),
               tnet.q_head.weight.detach().numpy()):
    assert np.abs(head).max() <= 0.03
  assert_equal(tnet.q_head.bias.detach(), np.full(3, -0.2, np.float32))
  assert_equal(np.asarray(jparams["Dense_0"]["bias"]),
               np.full(3, -0.2, np.float32))


def test_state_spec_and_empty_states():
  """The carry spec is flax's, and None or () start from zeros."""
  jnet, params, tnet = _pair("value")
  assert [(s.shape, s.name) for s in tnet.state_spec] == [
      (s.shape, s.name) for s in jnet.state_spec] == [((H,), "lstm_c"),
                                                      ((H,), "lstm_h")]
  obs, step_type, _ = _inputs(True, False)
  zeros = tuple(np.zeros((B, H), np.float32) for _ in range(2))
  with torch.no_grad():
    ref, ref_carry = _torch_apply(tnet, obs, step_type, zeros)
    for empty in (None, ()):
      out, carry = tnet(torch.from_numpy(obs), torch.from_numpy(step_type),
                        empty)
      assert_equal(out, ref)
      for a, b in zip(carry, ref_carry):
        assert_equal(a, b)
    # No step type: one MID step per row.
    out, _ = tnet(torch.from_numpy(obs[:, 0]))
    mid, _ = tnet(torch.from_numpy(obs[:, 0]),
                  torch.full((B,), ts.StepType.MID, dtype=torch.int32))
  assert out.shape == (B,)
  assert_equal(out, mid)


def test_converter_refuses_unknown_entries():
  _, params, _ = _pair("q")
  bad = {"params": {**params["params"], "Dense_1": params["params"]["Dense_0"]}}
  with pytest.raises(ValueError, match="Q RNN"):
    convert.q_rnn_params_to_state_dict(bad)
  with pytest.raises(ValueError, match="input layers"):
    convert.q_rnn_params_to_state_dict(params, num_input_layers=3)


def test_unroll_backward_passes_gradcheck():
  """The written-out backward of the masked unroll against finite
  differences, in float64, with resets mid-sequence and gradients flowing
  into the outputs and the final carry."""
  from agents_tpu_torch.networks.lstm_networks import _MaskedLSTMUnroll

  g = torch.Generator().manual_seed(0)
  b, t, h = 3, 5, 4
  args = (torch.randn(b, t, 4 * h, generator=g, dtype=torch.float64),
          torch.tensor([[1, 1, 0, 1, 1], [0, 1, 1, 1, 0], [1, 1, 1, 1, 1]],
                       dtype=torch.float64),
          torch.randn(4 * h, h, generator=g, dtype=torch.float64) * 0.5,
          torch.randn(b, h, generator=g, dtype=torch.float64),
          torch.randn(b, h, generator=g, dtype=torch.float64))
  for i in (0, 2, 3, 4):
    args[i].requires_grad_(True)
  assert torch.autograd.gradcheck(_MaskedLSTMUnroll.apply, args)


POLICIES = ("q_greedy", "q_epsilon_greedy", "actor", "actor_greedy")


def _policies(kind, jnet, tnet):
  from agents_tpu.policies import actor_policy as jactor
  from agents_tpu.policies import q_policy as jq
  from agents_tpu.policies import wrappers as jwrappers
  from agents_tpu.trajectories import time_step as jts
  from agents_tpu_torch.policies import actor_policy as tactor
  from agents_tpu_torch.policies import q_policy as tq
  from agents_tpu_torch.policies import wrappers as twrappers

  (jobs, jact), (tobs, tact) = _specs()
  jtss, ttss = jts.time_step_spec(jobs), ts.time_step_spec(tobs)
  if kind.startswith("q"):
    jpol = jq.QPolicy(jtss, jact, jnet)
    tpol = tq.QPolicy(ttss, tact, tnet)
    if kind == "q_epsilon_greedy":
      return (jwrappers.EpsilonGreedyPolicy(jpol, 0.0),
              twrappers.EpsilonGreedyPolicy(tpol, 0.0))
  else:
    jpol = jactor.ActorPolicy(jtss, jact, jnet)
    tpol = tactor.ActorPolicy(ttss, tact, tnet)
    if kind == "actor":
      return jpol, tpol
  return jwrappers.GreedyPolicy(jpol), twrappers.GreedyPolicy(tpol)


@pytest.mark.parametrize("kind", POLICIES)
def test_stateful_policies_carry_the_network_state_like_jax(kind):
  """Three steps of each policy from its `init_state`, rows restarting on
  FIRST: the actions (or the distribution's logits) and the state each
  returns agree with the JAX policy's."""
  from agents_tpu.trajectories import time_step as jts
  from agents_tpu_torch.utils.draws import Draws

  jnet, params, tnet = _pair("q" if kind.startswith("q")
                             else "actor_categorical")
  jpol, tpol = _policies(kind, jnet, tnet)
  jstate, tstate = jpol.init_state(B), tpol.init_state(B)
  assert [s.shape for s in tstate] == [(B, H)] * 2
  rng = np.random.RandomState(6)
  for step_type in ([0] * B, [1, 1, 1, 1, 1], [0, 1, 2, 0, 1]):
    obs = rng.randn(B, *OBS).astype(np.float32)
    st = np.asarray(step_type, np.int32)
    jstep = jts.TimeStep(step_type=jnp.asarray(st), reward=jnp.zeros(B),
                         discount=jnp.ones(B), observation=jnp.asarray(obs))
    tstep = ts.TimeStep(step_type=torch.from_numpy(st),
                        reward=torch.zeros(B), discount=torch.ones(B),
                        observation=torch.from_numpy(obs))
    if kind == "actor":
      jout = jpol.distribution(params, jstep, jstate)
      with torch.no_grad():
        tout = tpol.distribution(tnet, tstep, tstate)
      assert_close(tout.action.logits, jout.action.logits)
    else:
      jout = jpol.action(params, jstep, jstate, jax.random.key(0))
      with torch.no_grad():
        tout = tpol.action(tnet, tstep, tstate, Draws(0, "cpu"))
      assert_equal(tout.action, jout.action)
    for a, b in zip(tout.state, jout.state, strict=True):
      assert_close(a, b)
    jstate, tstate = jout.state, tout.state
