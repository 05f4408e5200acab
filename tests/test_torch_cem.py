"""Port parity: the CEM samplers and `CEMPolicy`
(`agents_tpu_torch.policies.cem_samplers`, `.cem_policy`) against the JAX
package's, and the one-hot action wrapper driven by CEM.

The JAX samplers draw from keys: per CEM iteration ``k, sub = split(k)``,
then `sub` split once per action leaf (in sorted-key order), a normal
``[N, B, *leaf]`` per Gaussian leaf and, per one-hot leaf, the uniforms in
[tiny, 1) of ``jax.random.categorical``'s Gumbel noise. `jax_cem_draws`
rebuilds them and the port replays them at "cem_normal" and
"cem_categorical". Float32 comparisons use rtol 1e-5 / atol 1e-6; the
actions `CEMPolicy.optimize` returns from replayed draws are held to rtol
1e-6 / atol 1e-7, an ulp or two: the refit's mean over the elites sums in
another order than XLA's, and any other elite would move an action far
more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.environments.jax_wrappers import OneHotActionJaxWrapper
from agents_tpu.policies import cem_samplers as jsamplers
from agents_tpu.policies.cem_policy import CEMPolicy as JaxCEMPolicy
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.environments import (BatchedTorchEnv,
                                           OneHotActionTorchWrapper)
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.networks import Network, make_critic_network
from agents_tpu_torch.policies import (CEMPolicy, GaussianContinuousSampler,
                                       GaussianHybridSampler,
                                       GaussianOneHotSampler)
from agents_tpu_torch.policies.cem_samplers import (sorted_leaves,
                                                    unflatten_sorted)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_cem_samplers import _critic as jax_target_critic
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_reset_draws, merge_draws)

torch.set_num_threads(1)

B, N, E = 4, 16, 4
SAMPLERS = {"continuous": (jsamplers.GaussianContinuousSampler,
                           GaussianContinuousSampler),
            "hybrid": (jsamplers.GaussianHybridSampler,
                       GaussianHybridSampler),
            "one_hot": (jsamplers.GaussianOneHotSampler,
                        GaussianOneHotSampler)}


def _specs(module, kind):
  """The action spec of each sampler's case; the dicts list their keys out
  of sorted order, so a sampler that took insertion order would cross the
  leaves."""
  cont = module.BoundedArraySpec((2,), np.float32, -1.0, 1.0)
  if kind == "continuous":
    return cont
  if kind == "hybrid":
    return {"disc": module.BoundedArraySpec((), np.int32, 0, 4),
            "cont": module.BoundedArraySpec((3,), np.float32,
                                            np.array([-1.0, 0.0, 2.0]),
                                            np.array([1.0, 5.0, 3.0]))}
  return {"onehot": module.BoundedArraySpec((4,), np.int32, 0, 1),
          "cont": cont}


def _is_one_hot(spec):
  return (np.issubdtype(spec.dtype, np.integer) and len(spec.shape) == 1
          and int(np.max(spec.maximum)) == 1)


def jax_cem_draws(key, num_iterations, num_samples, batch_size, action_spec):
  """Every draw of `CEMPolicy.optimize(params, time_step, key)` (JAX spec
  nest), per site."""
  leaves = jax.tree_util.tree_leaves(
      action_spec, is_leaf=lambda s: isinstance(s, jspec.ArraySpec))
  out = {"cem_normal": [], "cem_categorical": []}
  k = key
  for _ in range(num_iterations):
    k, sub = jax.random.split(k)
    for s, kk in zip(leaves, jax.random.split(sub, len(leaves))):
      if _is_one_hot(s):
        out["cem_categorical"].append(np.asarray(jax.random.uniform(
            kk, (num_samples, batch_size, s.shape[0]), jnp.float32,
            minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
      else:
        out["cem_normal"].append(np.asarray(jax.random.normal(
            kk, (num_samples, batch_size) + s.shape)))
  return {site: v for site, v in out.items() if v}


ACTION_RTOL, ACTION_ATOL = 1e-6, 1e-7


def _tuple_close(actual, expected, msg, rtol=1e-5, atol=1e-6):
  for i, (a, e) in enumerate(zip(actual, expected, strict=True)):
    assert_close(a, e, rtol, atol, err_msg=f"{msg} {i}")


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_sampler_matches_jax(kind):
  """init, one sample from replayed draws, the refit to JAX's top-k elites
  of a fixed score, and the mode."""
  jcls, tcls = SAMPLERS[kind]
  jsampler, tsampler = jcls(_specs(jspec, kind)), tcls(_specs(tspec, kind))
  assert [tuple(s.shape) for s in tsampler.specs] == [
      tuple(s.shape) for s in jsampler.specs]
  jparams = jsampler.init(B)
  tparams = tsampler.init(B, device="cpu")
  for j, t in zip(jparams, tparams):
    _tuple_close(t, j, "init")
  key = jax.random.key(3)
  jsamples = jsampler.sample_batch_and_clip(key, N, jparams)
  sub_keys = jax.random.split(key, len(jsampler.specs))
  records = {"cem_normal": [], "cem_categorical": []}
  for s, kk in zip(jsampler.specs, sub_keys):
    if _is_one_hot(s):
      records["cem_categorical"].append(np.asarray(jax.random.uniform(
          kk, (N, B, s.shape[0]), jnp.float32,
          minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))
    else:
      records["cem_normal"].append(np.asarray(jax.random.normal(
          kk, (N, B) + s.shape)))
  draws = ReplayDraws({k: v for k, v in records.items() if v})
  tsamples = tsampler.sample_batch_and_clip(draws, N, tparams)
  assert all(v == 0 for v in draws.remaining().values())
  _tuple_close(tsamples, jsamples, "samples")
  score = np.random.RandomState(0).randn(N, B).astype(np.float32)
  _, elite_idx = jax.lax.top_k(jnp.asarray(score).T, E)
  jrefit = jsampler.refit_distribution_to(elite_idx, jsamples)
  trefit = tsampler.refit_distribution_to(
      torch.from_numpy(np.array(elite_idx)).long(), tsamples)
  for j, t in zip(jrefit, trefit):
    _tuple_close(t, j, "refit")
  jmode, tmode = jsampler.mode(jrefit), tsampler.mode(trefit)
  _tuple_close(tmode, jmode, "mode")
  for j, t in zip(jmode, tmode):
    assert str(t.dtype).split(".")[-1] == str(j.dtype)


def test_sorted_leaves_round_trip_to_the_spec_nest():
  spec = {"b": 1, "a": (2, {"d": 3, "c": 4})}
  assert sorted_leaves(spec) == [2, 4, 3, 1]
  assert unflatten_sorted(spec, [20, 40, 30, 10]) == {
      "b": 10, "a": (20, {"d": 30, "c": 40})}
  assert list(unflatten_sorted(spec, [0] * 4)) == ["b", "a"]


def test_continuous_sampler_respects_bounds():
  sampler = GaussianContinuousSampler(_specs(tspec, "continuous"))
  samples = sampler.sample_batch_and_clip(Draws(0, "cpu"), 16,
                                          sampler.init(3, device="cpu"))
  assert samples[0].shape == (16, 3, 2)
  assert bool(((samples[0] >= -1.0) & (samples[0] <= 1.0)).all())


def test_hybrid_sampler_rounds_discrete_leaves_in_bounds():
  act = {"cont": tspec.BoundedArraySpec((2,), np.float32, -1.0, 1.0),
         "disc": tspec.BoundedArraySpec((), np.int32, 0, 4)}
  sampler = GaussianHybridSampler(act)
  samples = sampler.sample_batch_and_clip(Draws(0, "cpu"), 16,
                                          sampler.init(3, device="cpu"))
  disc = samples[1]
  assert torch.equal(disc, torch.round(disc))
  assert float(disc.min()) >= 0 and float(disc.max()) <= 4
  means, variances = sampler.refit_distribution_to(
      torch.zeros((3, 4), dtype=torch.long), samples)
  assert means[0].shape == (3, 2) and means[1].shape == (3,)
  mode = sampler.mode((means, variances))
  assert mode[1].dtype == torch.int32
  assert sampler.to_spec_dtypes(samples)[1].dtype == torch.int32


def test_one_hot_sampler_samples_valid_one_hots():
  act = {"cont": tspec.BoundedArraySpec((2,), np.float32, -1.0, 1.0),
         "onehot": tspec.BoundedArraySpec((4,), np.int32, 0, 1)}
  sampler = GaussianOneHotSampler(act)
  oh = sampler.sample_batch_and_clip(Draws(0, "cpu"), 16,
                                     sampler.init(3, device="cpu"))[1]
  assert oh.shape == (16, 3, 4)
  assert torch.equal(oh.sum(-1), torch.ones(16, 3))
  assert set(oh.unique().tolist()) == {0.0, 1.0}
  with pytest.raises(ValueError, match="GaussianHybridSampler"):
    GaussianOneHotSampler(tspec.BoundedArraySpec((), np.int32, 0, 4))
  with pytest.raises(ValueError, match="continuous"):
    GaussianContinuousSampler(tspec.BoundedArraySpec((), np.int32, 0, 4))


# -- CEMPolicy ----------------------------------------------------------------


class TargetCritic(Network):
  """Q peaks where the flattened, float-cast action (leaves in sorted-key
  order) equals `target`: the port twin of `test_cem_samplers._critic`."""

  def __init__(self, target):
    super().__init__(None)
    self.target = torch.tensor(target, dtype=torch.float32)

  def forward(self, inputs, step_type=None, network_state=()):
    _, action = inputs
    a = torch.cat([leaf.reshape(leaf.shape[0], -1).float()
                   for leaf in sorted_leaves(action)], dim=-1)
    return -torch.sum(torch.square(a - self.target), dim=-1), network_state


OBS3 = (3,)


def _policies(kind, target, num_samples, num_elites, num_iterations):
  jact, tact = _specs(jspec, kind), _specs(tspec, kind)
  if kind == "hybrid":
    jact = {"cont": jspec.BoundedArraySpec((1,), np.float32, -1.0, 1.0),
            "disc": jspec.BoundedArraySpec((), np.int32, 0, 4)}
    tact = {"cont": tspec.BoundedArraySpec((1,), np.float32, -1.0, 1.0),
            "disc": tspec.BoundedArraySpec((), np.int32, 0, 4)}
  if kind == "one_hot":
    jact = jspec.BoundedArraySpec((4,), np.int32, 0, 1)
    tact = tspec.BoundedArraySpec((4,), np.int32, 0, 1)
  jcls, tcls = SAMPLERS[kind]
  jobs = jspec.ArraySpec(OBS3, np.float32)
  jnet = jax_target_critic(target, (jobs, jact))
  jpol = JaxCEMPolicy(jts.time_step_spec(jobs), jact, jnet,
                      num_samples=num_samples, num_elites=num_elites,
                      num_iterations=num_iterations, sampler=jcls(jact))
  tobs = tspec.ArraySpec(OBS3, np.float32)
  tnet = TargetCritic(target)
  tpol = CEMPolicy(tts.time_step_spec(tobs), tact, tnet,
                   num_samples=num_samples, num_elites=num_elites,
                   num_iterations=num_iterations, sampler=tcls(tact))
  return (jpol, jnet), (tpol, tnet)


CASES = {"continuous": ([0.5, -0.25], 64, 8, 10),
         "hybrid": ([0.5, 3.0], 128, 8, 10),
         "one_hot": ([0.0, 0.0, 1.0, 0.0], 64, 8, 8)}


@pytest.mark.parametrize("kind", list(CASES))
def test_cem_optimize_matches_jax_and_finds_the_target(kind):
  """The counterparts of `tests/test_cem_samplers.py`'s policy tests, with
  JAX's per-iteration draws replayed: the same actions (to an ulp or two)
  and the same Q values; and the optimum found (continuous within 0.1, the
  hybrid's discrete leaf and the one-hot category exactly)."""
  target, n, e, iters = CASES[kind]
  (jpol, jnet), (tpol, tnet) = _policies(kind, target, n, e, iters)
  params = jnet.init_params(jax.random.key(0), batch_size=2)
  key = jax.random.key(1)
  jaction, jq = jax.jit(jpol.optimize)(params, jts.restart(
      jnp.zeros((B, 3)), batch_size=B), key)
  draws = ReplayDraws(jax_cem_draws(key, iters, n, B, jpol.action_spec))
  taction, tq = tpol.optimize(tnet, tts.restart(torch.zeros(B, 3), B), draws)
  assert all(v == 0 for v in draws.remaining().values())
  jleaves = jax.tree_util.tree_leaves(jaction)
  tleaves = sorted_leaves(taction)
  _tuple_close(tleaves, jleaves, "action", ACTION_RTOL, ACTION_ATOL)
  assert_close(tq, jq)
  if kind == "continuous":
    assert_close(taction, np.tile([0.5, -0.25], (B, 1)), atol=0.1)
  elif kind == "hybrid":
    assert_close(taction["cont"][:, 0], np.full(B, 0.5), atol=0.15)
    assert_equal(taction["disc"], np.full(B, 3, np.int32))
    assert taction["disc"].dtype == torch.int32
  else:
    assert_equal(torch.argmax(taction, -1), np.full(B, 2))


def test_cem_policy_acts_in_bounds_and_has_no_distribution():
  (_, _), (tpol, tnet) = _policies("continuous", [0.5, -0.25], 8, 2, 2)
  step = tpol.action(tnet, tts.restart(torch.zeros(3, 3), 3), (),
                     Draws(0, "cpu"))
  assert tuple(step.action.shape) == (3, 2) and step.info == ()
  assert bool((step.action.abs() <= 1.0).all())
  with pytest.raises(NotImplementedError):
    tpol.distribution(tnet, tts.restart(torch.zeros(3, 3), 3))


def _mlp_critics(obs_spec_shape, act_shape, lo, hi, fc=(16, 16)):
  jobs = jspec.ArraySpec(obs_spec_shape, np.float32)
  jact = jspec.BoundedArraySpec(act_shape, np.float32, lo, hi)
  jnet = jnetworks.make_critic_network(jobs, jact, joint_fc_layer_params=fc)
  params = jax.device_get(jnet.init_params(jax.random.key(4)))
  tobs = tspec.ArraySpec(obs_spec_shape, np.float32)
  tact = tspec.BoundedArraySpec(act_shape, np.float32, lo, hi)
  tnet = make_critic_network(tobs, tact, joint_fc_layer_params=fc,
                             device="cpu")
  tnet.load_state_dict(convert.sac_critic_params_to_state_dict(params))
  return (jobs, jact, jnet, params), (tobs, tact, tnet)


def test_cem_over_an_mlp_critic_matches_jax():
  """The QtOpt defaults (32 samples, 4 elites, 3 iterations) over a (16,
  16) critic at Pendulum's shapes: the same elites every iteration, so the
  same actions to an ulp or two."""
  (jobs, jact, jnet, params), (tobs, tact, tnet) = _mlp_critics(
      (3,), (1,), -2.0, 2.0)
  jpol = JaxCEMPolicy(jts.time_step_spec(jobs), jact, jnet)
  tpol = CEMPolicy(tts.time_step_spec(tobs), tact, tnet)
  obs = (np.random.RandomState(2).randn(8, 3) * 2).astype(np.float32)
  key = jax.random.key(9)
  jaction, jq = jpol.optimize(params, jts.restart(jnp.asarray(obs), 8), key)
  draws = ReplayDraws(jax_cem_draws(key, 3, 32, 8, jact))
  taction, tq = tpol.optimize(tnet, tts.restart(torch.from_numpy(obs), 8),
                              draws)
  assert_close(taction, jaction, ACTION_RTOL, ACTION_ATOL)
  assert_close(tq, jq)


def test_one_hot_wrapper_driven_by_cem_matches_jax():
  """CEM over the one-hot wrapper's float (2,) action spec drives CartPole:
  the same action vectors (to an ulp or two), so the same decoded steps,
  as the JAX wrapper's."""
  jenv = BatchedJaxEnv(OneHotActionJaxWrapper(JaxCartPole()), batch_size=B)
  tenv = BatchedTorchEnv(OneHotActionTorchWrapper(CartPole()), B,
                         device="cpu")
  assert tenv.action_spec() == tspec.BoundedArraySpec((2,), np.float32, 0.0,
                                                      1.0)
  assert tenv.action_spec().name == jenv.action_spec().name
  (jobs, jact, jnet, params), (tobs, tact, tnet) = _mlp_critics(
      (4,), (2,), 0.0, 1.0)
  jpol = JaxCEMPolicy(jts.time_step_spec(jobs), jact, jnet)
  tpol = CEMPolicy(tts.time_step_spec(tobs), tact, tnet)
  k_reset, k_pol = jax.random.split(jax.random.key(5))
  jstate, jts0 = jenv.reset(k_reset)
  jaction, _ = jpol.optimize(params, jts0, k_pol)
  _, jts1 = jenv.step(jstate, jts0, jaction, jax.random.key(6))
  draws = ReplayDraws(merge_draws(
      {"env_reset": [jax_reset_draws(k_reset, B)]},
      jax_cem_draws(k_pol, 3, 32, B, jact),
      {"env_reset": [jax_reset_draws(jax.random.key(0), B)]}))
  tstate, tts0 = tenv.reset(draws)
  taction, _ = tpol.optimize(tnet, tts0, draws)
  _, tts1 = tenv.step(tstate, tts0, taction, draws)
  assert_close(taction, jaction, ACTION_RTOL, ACTION_ATOL)
  assert_equal(torch.argmax(taction, -1), jnp.argmax(jaction, -1))
  assert_close(tts1.observation, jts1.observation)
  assert_equal(tts1.step_type, jts1.step_type)
  with pytest.raises(ValueError, match="scalar integer"):
    OneHotActionTorchWrapper(OneHotActionTorchWrapper(CartPole()))
