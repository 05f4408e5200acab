"""Port parity: the on-policy slice's distributions and networks against
the JAX package's.

  - `Categorical` log-prob, entropy and KL, and the `Normal` /
    `Independent` KL, on numpy-made parameters;
  - `CategoricalProjection` and `NormalProjection` (default, std bias for
    0.35, state-dependent std, `scale_distribution`) inside the actor
    network, and `ValueModule`, at (16,) and (64, 64), from flax params
    carried across by `convert`;
  - the port's own init against flax's distributions;
  - static dataclass fields in `nest_utils.tree_map`.

Float32 rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import functools
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import distributions as jdist
from agents_tpu import networks as jnetworks
from agents_tpu.networks.projection_networks import \
    NormalProjection as JaxNormalProjection
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch import distributions as tdist
from agents_tpu_torch.networks import (CategoricalProjection,
                                       NormalProjection,
                                       make_actor_distribution_network,
                                       make_value_network)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.utils import common, convert, nest_utils
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B = 7
STD_035 = math.log(math.exp(0.35) - 1.0)


def _t(x):
  return torch.from_numpy(np.asarray(x))


# -- distributions -------------------------------------------------------------


def test_categorical_log_prob_entropy_kl_match_jax():
  rng = np.random.RandomState(0)
  logits, other = (rng.randn(B, 5).astype(np.float32) * 2 for _ in range(2))
  actions = rng.randint(0, 5, B).astype(np.int32)
  jd, jo = jdist.Categorical(jnp.asarray(logits)), jdist.Categorical(
      jnp.asarray(other))
  td, to = tdist.Categorical(_t(logits)), tdist.Categorical(_t(other))
  assert_close(td.log_prob(_t(actions)), jd.log_prob(jnp.asarray(actions)))
  assert_close(td.entropy(), jd.entropy())
  assert_close(td.kl_divergence(to), jd.kl_divergence(jo))
  assert_close(tdist.kl_divergence(td, to), jdist.kl_divergence(jd, jo))
  assert_close(td.probs, jd.probs)
  assert_close(td.log_probs, jd.log_probs)
  assert_equal(td.mode(), jd.mode())
  assert td.log_prob(_t(actions)).dtype == torch.float32
  # KL of a distribution with itself is zero.
  assert_close(td.kl_divergence(td), np.zeros(B, np.float32), 0, 1e-6)


def test_normal_and_independent_kl_match_jax():
  rng = np.random.RandomState(1)
  loc, loc2 = (rng.randn(B, 3).astype(np.float32) for _ in range(2))
  scale, scale2 = (rng.uniform(0.2, 2.0, (B, 3)).astype(np.float32)
                   for _ in range(2))
  jn, jn2 = jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)), jdist.Normal(
      jnp.asarray(loc2), jnp.asarray(scale2))
  tn, tn2 = tdist.Normal(_t(loc), _t(scale)), tdist.Normal(_t(loc2),
                                                           _t(scale2))
  assert_close(tn.kl_divergence(tn2), jn.kl_divergence(jn2))
  ji, ti = jdist.Independent(jn, 1), tdist.Independent(tn, 1)
  assert_close(ti.kl_divergence(tdist.Independent(tn2, 1)),
               ji.kl_divergence(jdist.Independent(jn2, 1)))
  # Against a bare Normal, as the JAX method allows.
  assert_close(ti.kl_divergence(tn2), ji.kl_divergence(jn2))
  assert tuple(ti.kl_divergence(tn2).shape) == (B,)


def test_log_probability_and_entropy_sum_over_a_nest():
  rng = np.random.RandomState(2)
  logits = rng.randn(B, 3).astype(np.float32)
  loc = rng.randn(B, 2).astype(np.float32)
  scale = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
  acts = {"d": rng.randint(0, 3, B).astype(np.int32),
          "c": rng.randn(B, 2).astype(np.float32)}
  tnest = {"d": tdist.Categorical(_t(logits)),
           "c": tdist.Independent(tdist.Normal(_t(loc), _t(scale)), 1)}
  jnest = {"d": jdist.Categorical(jnp.asarray(logits)),
           "c": jdist.Independent(jdist.Normal(jnp.asarray(loc),
                                               jnp.asarray(scale)), 1)}
  from agents_tpu.utils import common as jcommon
  assert_close(common.log_probability(tnest, {k: _t(v) for k, v in
                                              acts.items()}),
               jcommon.log_probability(jnest, jax.tree_util.tree_map(
                   jnp.asarray, acts)))
  assert_close(common.entropy(tnest), jcommon.entropy(jnest))


# -- static dataclass fields ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _WithStatic:
  x: object
  n: int = nest_utils.static_field(default=3)


def test_tree_map_passes_static_fields_through():
  """A distribution's dtype and event dims are no leaves: slicing a nest
  of distributions touches only their tensors; flatten skips them."""
  d = tdist.Independent(tdist.Categorical(torch.zeros(4, 3, 2)), 1)
  sliced = nest_utils.tree_map(lambda x: x[:, :-1], d)
  assert tuple(sliced.base.logits.shape) == (4, 2, 2)
  assert sliced.reinterpreted_batch_ndims == 1
  assert sliced.base.dtype is torch.int32
  assert len(nest_utils.flatten(d)) == 1
  stacked = nest_utils.stack_nested_tensors([_WithStatic(torch.ones(2), 5)] * 3)
  assert tuple(stacked.x.shape) == (3, 2) and stacked.n == 5
  pair = nest_utils.tree_map(lambda a, b: a + b, _WithStatic(1, 7),
                             _WithStatic(2, 9))
  assert pair == _WithStatic(3, 7)
  assert nest_utils.flatten(_WithStatic([1, 2])) == [1, 2]


def test_tree_map_leaves_plain_dataclasses_as_before():
  @dataclasses.dataclass(frozen=True)
  class Plain:
    a: object
    b: object = 2

  assert nest_utils.tree_map(lambda v: v * 10, Plain(1)) == Plain(10, 20)
  assert nest_utils.flatten(Plain((1, {"k": 3}), None)) == [1, 3]


# -- networks from converted flax params ---------------------------------------


def _discrete(m, shape=()):
  return (m.ArraySpec((4,), np.float32),
          m.BoundedArraySpec(shape, np.int32, 0, 2))


def _continuous(m):
  return (m.ArraySpec((3,), np.float32),
          m.BoundedArraySpec((2,), np.float32, [-2.0, -1.0], [2.0, 3.0]))


HEADS = {
    "default": ({}, {}),
    "std_035": ({"std_bias_initializer_value": STD_035},) * 2,
    "state_dependent": ({"state_dependent_std": True,
                         "std_bias_initializer_value": 0.2},) * 2,
    "scale_distribution": ({"scale_distribution": True},) * 2,
}


def _actor_pair(kind, fc, seed=0, activation="relu"):
  """(jax net, flax params, port net), the port's weights converted from
  flax's."""
  acts = {"relu": (fnn.relu, torch.relu), "tanh": (fnn.tanh, torch.tanh)}
  jact, tact = acts[activation]
  if kind in ("discrete", "discrete_1"):
    shape = (1,) if kind == "discrete_1" else ()
    (jobs, jasp), (tobs, tasp) = _discrete(jspec, shape), _discrete(tspec,
                                                                   shape)
    jproj, tproj = JaxNormalProjection, NormalProjection
  else:
    (jobs, jasp), (tobs, tasp) = _continuous(jspec), _continuous(tspec)
    jkw, tkw = HEADS[kind]
    jproj = functools.partial(JaxNormalProjection, **jkw)
    tproj = functools.partial(NormalProjection, **tkw)
  jnet = jnetworks.make_actor_distribution_network(
      jobs, jasp, fc_layer_params=fc, activation=jact,
      continuous_projection=jproj)
  params = jax.device_get(jnet.init_params(jax.random.key(seed)))
  tnet = make_actor_distribution_network(
      tobs, tasp, fc_layer_params=fc, activation=tact,
      continuous_projection=tproj, device="cpu")
  sd = convert.actor_params_to_state_dict(params)
  assert list(sd) == list(tnet.state_dict())
  tnet.load_state_dict(sd)
  return jnet, params, tnet


def _obs(dim, seed=3):
  return np.random.RandomState(seed).randn(B, dim).astype(np.float32) * 2


@pytest.mark.parametrize("fc", [(16,), (64, 64)])
@pytest.mark.parametrize("kind", ["discrete", "discrete_1"])
def test_categorical_actor_matches_flax(kind, fc):
  jnet, params, tnet = _actor_pair(kind, fc)
  obs = _obs(4)
  jd, _ = jnet.apply(params, jnp.asarray(obs))
  td, _ = tnet(_t(obs))
  if kind == "discrete_1":
    assert isinstance(td, tdist.Independent)
    jd, td = jd.base, td.base
    acts = np.random.RandomState(5).randint(0, 3, (B, 1)).astype(np.int32)
  else:
    assert isinstance(td, tdist.Categorical) and td.dtype is torch.int32
    acts = np.random.RandomState(5).randint(0, 3, B).astype(np.int32)
  assert_close(td.logits, jd.logits, RTOL, ATOL)
  assert_close(td.log_prob(_t(acts)), jd.log_prob(jnp.asarray(acts)), RTOL,
               ATOL)
  assert_close(td.entropy(), jd.entropy(), RTOL, ATOL)
  assert_equal(td.mode(), jd.mode())


@pytest.mark.parametrize("fc", [(16,), (64, 64)])
@pytest.mark.parametrize("kind", list(HEADS))
def test_normal_projection_actor_matches_flax(kind, fc):
  jnet, params, tnet = _actor_pair(kind, fc, seed=1, activation="tanh")
  obs = _obs(3)
  acts = np.random.RandomState(6).uniform(-0.9, 0.9, (B, 2)).astype(
      np.float32)
  jd, _ = jnet.apply(params, jnp.asarray(obs))
  td, _ = tnet(_t(obs))
  assert type(td).__name__ == type(jd).__name__
  assert_close(td.log_prob(_t(acts)), jd.log_prob(jnp.asarray(acts)), RTOL,
               ATOL)
  assert_close(td.mode(), jd.mode(), RTOL, ATOL)
  assert_close(td.stddev(), jd.stddev(), RTOL, ATOL)
  if kind != "scale_distribution":
    assert_close(td.entropy(), jd.entropy(), RTOL, ATOL)
    other = jnet.apply(params, jnp.asarray(obs[::-1].copy()))[0]
    tother = tnet(_t(obs[::-1].copy()))[0]
    assert_close(td.kl_divergence(tother), jd.kl_divergence(other), RTOL,
                 ATOL)
  if kind == "std_035":
    # The state-independent std starts at 0.35 + min_std.
    assert_close(td.stddev(), np.full((B, 2), 0.351, np.float32), 1e-5)


@pytest.mark.parametrize("fc", [(16,), (64, 64)])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_value_network_matches_flax(fc, activation):
  jobs, tobs = jspec.ArraySpec((4,), np.float32), tspec.ArraySpec(
      (4,), np.float32)
  jact, tact = {"relu": (fnn.relu, torch.relu),
                "tanh": (fnn.tanh, torch.tanh)}[activation]
  jnet = jnetworks.make_value_network(jobs, fc_layer_params=fc,
                                      activation=jact)
  params = jax.device_get(jnet.init_params(jax.random.key(2)))
  tnet = make_value_network(tobs, fc_layer_params=fc, activation=tact,
                            device="cpu")
  sd = convert.value_params_to_state_dict(params)
  assert list(sd) == list(tnet.state_dict())
  tnet.load_state_dict(sd)
  obs = _obs(4)
  jv, _ = jnet.apply(params, jnp.asarray(obs))
  tv, _ = tnet(_t(obs))
  assert tuple(tv.shape) == (B,) and tv.dtype == torch.float32
  assert_close(tv, jv, RTOL, ATOL)


def test_converters_refuse_unknown_trees():
  with pytest.raises(ValueError):
    convert.value_params_to_state_dict(
        {"params": {"EncoderModule_0": {}, "Dense_0": {}, "Dense_1": {}}})
  with pytest.raises(ValueError):
    convert.actor_params_to_state_dict(
        {"params": {"EncoderModule_0": {}, "CategoricalProjection_0": {},
                    "NormalProjection_0": {}}})
  with pytest.raises(ValueError):
    convert.actor_params_to_state_dict(
        {"params": {"EncoderModule_0": {}, "NormalProjection_0": {
            "Dense_0": {}, "bogus": {}}}})


def test_init_distributions_match_flax():
  """Categorical logits and Normal means: U(±0.1) kernels; the std Dense
  too; the value head U(±0.03); biases zero but the std bias, which holds
  its initial value. Checked on the port's own init and flax's, at
  (64, 64)."""
  _, jparams, _ = _actor_pair("discrete", (64, 64), seed=4)
  tactor = make_actor_distribution_network(*_discrete(tspec),
                                           fc_layer_params=(64, 64),
                                           device="cpu")
  for sample in (np.asarray(jparams["params"]["CategoricalProjection_0"][
      "Dense_0"]["kernel"]), tactor.projections[0].dense.weight.detach()
                 .numpy()):
    assert np.abs(sample).max() <= 0.1
    assert abs(sample.std() / (0.1 / math.sqrt(3)) - 1.0) < 0.2
  _, jcont, _ = _actor_pair("state_dependent", (64, 64), seed=4)
  tcont = make_actor_distribution_network(
      *_continuous(tspec), fc_layer_params=(64, 64),
      continuous_projection=functools.partial(
          NormalProjection, state_dependent_std=True,
          std_bias_initializer_value=0.2), device="cpu")
  jhead = jcont["params"]["NormalProjection_0"]
  thead = tcont.projections[0]
  for sample in (np.asarray(jhead["Dense_0"]["kernel"]),
                 np.asarray(jhead["Dense_1"]["kernel"]),
                 thead.means.weight.detach().numpy(),
                 thead.stds.weight.detach().numpy()):
    assert np.abs(sample).max() <= 0.1
  for bias in (np.asarray(jhead["Dense_1"]["bias"]),
               thead.stds.bias.detach().numpy()):
    assert_equal(bias, np.full(2, 0.2, np.float32))
  tdefault = make_actor_distribution_network(
      *_continuous(tspec), fc_layer_params=(8,),
      continuous_projection=functools.partial(
          NormalProjection, std_bias_initializer_value=STD_035),
      device="cpu")
  assert_close(tdefault.projections[0].std_bias.detach(),
               np.full(2, STD_035, np.float32))
  jvalue = jnetworks.make_value_network(jspec.ArraySpec((4,), np.float32),
                                        fc_layer_params=(64, 64))
  jv = jax.device_get(jvalue.init_params(jax.random.key(4)))
  tv = make_value_network(tspec.ArraySpec((4,), np.float32), device="cpu")
  for sample in (np.asarray(jv["params"]["Dense_0"]["kernel"]),
                 tv.value_head.weight.detach().numpy()):
    assert np.abs(sample).max() <= 0.03
    assert abs(sample.std() / (0.03 / math.sqrt(3)) - 1.0) < 0.35
  for net in (tactor, tv):
    for name, p in net.named_parameters():
      if name.endswith("bias"):
        assert_equal(p.detach(), np.zeros(p.shape, np.float32))


def test_projection_heads_by_spec():
  obs, disc = _discrete(tspec)
  _, cont = _continuous(tspec)
  net = make_actor_distribution_network(obs, {"d": disc, "c": cont},
                                        fc_layer_params=(8,), device="cpu")
  # One head per leaf, in the port's nest order (a dict's insertion order).
  assert [type(p) for p in net.projections] == [CategoricalProjection,
                                                NormalProjection]
  dist, _ = net(torch.zeros(2, 4))
  assert isinstance(dist["d"], tdist.Categorical)
  assert isinstance(dist["c"], tdist.Independent)
  with pytest.raises(ValueError, match="scalar action spec"):
    make_actor_distribution_network(
        obs, tspec.BoundedArraySpec((2,), np.int32, 0, 2), device="cpu")
