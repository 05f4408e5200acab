"""Port parity: the discrete-action surface against the JAX package —
masked and shifted Q policies, epsilon-greedy exploration inside the mask
and the shift, Boltzmann sampling, `emit_log_probability`, DQN, DDQN and
C51 with an action-constraint splitter, DQN's Boltzmann collect policy,
and `FixedPolicy` and `ScriptedPolicy`. The port's counterparts of
`tests/test_parity_extras.py:109-204`.

The splitter cuts a ``[B, 6 + 3]`` observation into the network's 6
features and a mask over 3 actions (a row's mask always has a valid
action). Sampled actions replay the JAX side's draws: a categorical
sample's uniforms in [tiny, 1) of ``jax.random.categorical``'s Gumbel
noise, over ``[B, K]``. Actions and step types agree exactly, floats to
rtol 1e-5 / atol 1e-6.

The JAX package's `agents_tpu.distributions` does not export `NEG_INF`,
which its `QPolicy` (q_policy.py:54, a shifted and masked policy) and
`EpsilonGreedyPolicy` (wrappers.py:116-118, over a shifted policy) read
from it, so both raise `AttributeError` there. The fixture below sets the
name on that module for these tests only, to the value its
`distributions.py:238` defines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agents_tpu.distributions as jdistributions
from agents_tpu import networks as jnetworks
from agents_tpu.distributions import distributions as jdistributions_module
from agents_tpu.agents.categorical_dqn import \
    CategoricalDqnAgent as JaxCategoricalDqnAgent
from agents_tpu.agents.dqn import DdqnAgent as JaxDdqnAgent
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.policies import q_policy as jq_policy
from agents_tpu.policies import random_policy as jrandom_policy
from agents_tpu.policies import wrappers as jwrappers
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.agents.categorical_dqn import CategoricalDqnAgent
from agents_tpu_torch.agents.dqn import DdqnAgent, DqnAgent
from agents_tpu_torch.networks import (make_categorical_q_network,
                                       make_q_network, mask_splitter)
from agents_tpu_torch.policies import (BoltzmannPolicy, CategoricalQPolicy,
                                       EpsilonGreedyPolicy, FixedPolicy,
                                       GreedyPolicy, QPolicy, ScriptedPolicy)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import policy_step as tps
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

B, FEATURES, K = 32, 6, 3
FC = (16,)


@pytest.fixture(autouse=True)
def _jax_neg_inf(monkeypatch):
  monkeypatch.setattr(jdistributions, "NEG_INF",
                      jdistributions_module.NEG_INF, raising=False)


def _jax_split(obs):
  return obs[..., :FEATURES], obs[..., FEATURES:] > 0.5


def _torch_split(obs):
  return obs[..., :FEATURES], obs[..., FEATURES:] > 0.5


def _observations(seed=0, batch=B):
  """[batch, 6 + 3]: features, then a mask with at least one valid action
  (and some rows with a single one)."""
  rng = np.random.RandomState(seed)
  mask = rng.rand(batch, K) < 0.5
  mask[np.arange(batch), rng.randint(0, K, batch)] = True
  return np.concatenate([rng.randn(batch, FEATURES), mask], -1).astype(
      np.float32)


def _q_networks(minimum=0, categorical=False):
  """(JAX network, its params, port network with those weights) over the
  6 features, K actions from `minimum`."""
  jobs = jspec.ArraySpec((FEATURES,), np.float32)
  jact = jspec.BoundedArraySpec((), np.int32, minimum, minimum + K - 1)
  tobs = tspec.ArraySpec((FEATURES,), np.float32)
  tact = tspec.BoundedArraySpec((), np.int32, minimum, minimum + K - 1)
  if categorical:
    jnet = jnetworks.make_categorical_q_network(jobs, jact, num_atoms=11,
                                                fc_layer_params=FC)
    tnet = make_categorical_q_network(tobs, tact, num_atoms=11,
                                      fc_layer_params=FC, device="cpu")
  else:
    jnet = jnetworks.make_q_network(jobs, jact, fc_layer_params=FC)
    tnet = make_q_network(tobs, tact, fc_layer_params=FC, device="cpu")
  params = jax.device_get(jnet.init_params(jax.random.key(minimum + 7)))
  tnet.load_state_dict(convert.q_params_to_state_dict(params))
  return jnet, params, tnet


def _full_specs(module, minimum=0, masked=True):
  obs = module.ArraySpec((FEATURES + K if masked else FEATURES,), np.float32)
  act = module.BoundedArraySpec((), np.int32, minimum, minimum + K - 1)
  return obs, act


def _steps(obs):
  return (jts.restart(jnp.asarray(obs), batch_size=obs.shape[0]),
          tts.restart(torch.from_numpy(obs), obs.shape[0]))


def _q_policies(minimum=0, masked=True, emit=False):
  jnet, params, tnet = _q_networks(minimum)
  jobs, jact = _full_specs(jspec, minimum, masked)
  tobs, tact = _full_specs(tspec, minimum, masked)
  jpol = jq_policy.QPolicy(
      jts.time_step_spec(jobs), jact, jnet,
      observation_and_action_constraint_splitter=_jax_split if masked
      else None, emit_log_probability=emit)
  tpol = QPolicy(tts.time_step_spec(tobs), tact, tnet,
                 observation_and_action_constraint_splitter=(
                     mask_splitter(_torch_split) if masked else None),
                 emit_log_probability=emit)
  return (jpol, params), (tpol, tnet)


def _case_observations(seed, masked):
  """`_observations`, its mask columns cut off for an unmasked policy."""
  obs = _observations(seed)
  return obs if masked else obs[:, :FEATURES]


def _gumbel_uniforms(key, shape):
  return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                       minval=jnp.finfo(jnp.float32).tiny,
                                       maxval=1.0))


CASES = {"masked": dict(minimum=0, masked=True),
         "shifted": dict(minimum=1, masked=False),
         "shifted_masked": dict(minimum=1, masked=True)}
DISTRIBUTIONS = {"masked": dist_lib.MaskedCategorical,
                 "shifted": dist_lib.ShiftedCategorical,
                 "shifted_masked": dist_lib.ShiftedCategorical}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_q_policy_matches_jax(case):
  """The mode inside the mask and the shift, and the distribution's
  log-probabilities and entropy."""
  (jpol, params), (tpol, tnet) = _q_policies(**CASES[case])
  obs = _case_observations(1, CASES[case]["masked"])
  jstep, tstep = _steps(obs)
  jaction = jwrappers.GreedyPolicy(jpol).action(params, jstep, (),
                                                jax.random.key(0)).action
  taction = GreedyPolicy(tpol).action(tnet, tstep).action
  assert_equal(taction, jaction)
  assert taction.dtype == torch.int32
  minimum = CASES[case]["minimum"]
  assert int(taction.min()) >= minimum and int(taction.max()) < minimum + K
  if CASES[case]["masked"]:
    assert bool(obs[np.arange(B), FEATURES + taction.numpy() - minimum].all())
  jd = jpol.distribution(params, jstep, ()).action
  td = tpol.distribution(tnet, tstep).action
  assert isinstance(td, DISTRIBUTIONS[case])
  assert_close(td.log_prob(taction), jd.log_prob(jaction))
  assert_close(td.entropy(), jd.entropy())


@pytest.mark.parametrize("case", list(CASES))
def test_epsilon_greedy_explores_inside_the_mask_and_shift(case):
  """Epsilon 0.5: the exploring rows draw a uniform action among the valid
  ones (site "masked_random_action"), as the JAX wrapper does."""
  (jpol, params), (tpol, tnet) = _q_policies(**CASES[case])
  obs = _case_observations(2, CASES[case]["masked"])
  jstep, tstep = _steps(obs)
  key = jax.random.key(3)
  jaction = jwrappers.EpsilonGreedyPolicy(jpol, 0.5).action(
      params, jstep, (), key).action
  _, k_rand, k_mix = jax.random.split(key, 3)
  coin = np.asarray(jax.random.uniform(k_mix, (B,)))
  draws = ReplayDraws({"masked_random_action": [_gumbel_uniforms(k_rand,
                                                                 (B, K))],
                       "explore": [coin]})
  taction = EpsilonGreedyPolicy(tpol, 0.5).action(tnet, tstep, (),
                                                  draws).action
  assert all(v == 0 for v in draws.remaining().values())
  assert_equal(taction, jaction)
  minimum = CASES[case]["minimum"]
  if CASES[case]["masked"]:
    assert bool(obs[np.arange(B), FEATURES + taction.numpy() - minimum].all())
  assert int(taction.min()) >= minimum and int(taction.max()) < minimum + K
  greedy = GreedyPolicy(tpol).action(tnet, tstep).action
  explored = torch.from_numpy(coin < 0.5)
  assert bool((taction[explored] != greedy[explored]).any())


@pytest.mark.parametrize("case", ["plain", *CASES])
def test_boltzmann_samples_match_jax(case):
  """Temperature 0.5 over the (masked, shifted) Q logits: the default
  `Policy._action` sample, site "categorical"."""
  kwargs = CASES.get(case, dict(minimum=0, masked=False))
  (jpol, params), (tpol, tnet) = _q_policies(**kwargs)
  obs = _case_observations(4, kwargs["masked"])
  jstep, tstep = _steps(obs)
  key = jax.random.key(5)
  jaction = jwrappers.BoltzmannPolicy(jpol, 0.5).action(params, jstep, (),
                                                         key).action
  draws = ReplayDraws({"categorical": [
      _gumbel_uniforms(jax.random.split(key, 1)[0], (B, K))]})
  tpolicy = BoltzmannPolicy(tpol, 0.5)
  taction = tpolicy.action(tnet, tstep, (), draws).action
  assert_equal(taction, jaction)
  jd = jwrappers.BoltzmannPolicy(jpol, 0.5).distribution(params, jstep,
                                                         ()).action
  td = tpolicy.distribution(tnet, tstep).action
  assert_close(td.log_prob(taction), jd.log_prob(jaction))
  with pytest.raises(ValueError, match="categorical"):
    BoltzmannPolicy(GreedyPolicy(tpol)).distribution(tnet, tstep)


def test_emit_log_probability_matches_jax():
  """A sampling Q policy writes the sample's log-probability into the info;
  greedy over it writes 0 (the mode is deterministic)."""
  (jpol, params), (tpol, tnet) = _q_policies(minimum=0, masked=True,
                                             emit=True)
  obs = _observations(6)
  jstep, tstep = _steps(obs)
  key = jax.random.key(7)
  jout = jpol.action(params, jstep, (), key)
  draws = ReplayDraws({"categorical": [
      _gumbel_uniforms(jax.random.split(key, 1)[0], (B, K))]})
  tout = tpol.action(tnet, tstep, (), draws)
  assert_equal(tout.action, jout.action)
  assert_close(tps.get_log_probability(tout.info),
               jps.get_log_probability(jout.info))
  greedy = GreedyPolicy(tpol)
  assert greedy.emit_log_probability
  info = greedy.action(tnet, tstep).info
  assert_equal(tps.get_log_probability(info), np.zeros(B, np.float32))
  assert not EpsilonGreedyPolicy(tpol).emit_log_probability


# -- agents with a splitter --------------------------------------------------


def _experiences(n, seed):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    obs = np.stack([_observations(rng.randint(1 << 20), 16)
                    for _ in range(2)], 1)
    mask = obs[:, 0, FEATURES:] > 0.5
    action = np.array([rng.choice(np.flatnonzero(m)) for m in mask],
                      np.int32)
    out.append(dict(
        step_type=rng.choice([0, 1, 2], (16, 2), p=[0.2, 0.6, 0.2]).astype(
            np.int32),
        observation=obs, action=np.stack([action, action], 1),
        next_step_type=rng.choice([0, 1, 2], (16, 2)).astype(np.int32),
        reward=rng.randn(16, 2).astype(np.float32),
        discount=rng.choice([0.0, 1.0], (16, 2), p=[0.2, 0.8]).astype(
            np.float32)))
  return out


AGENTS = {"dqn": (JaxDqnAgent, DqnAgent, False),
          "ddqn": (JaxDdqnAgent, DdqnAgent, False),
          "c51": (JaxCategoricalDqnAgent, CategoricalDqnAgent, True)}


@pytest.mark.parametrize("name", list(AGENTS))
def test_agents_with_a_splitter_train_as_jax(name):
  """Two Adam steps from the same weights: the masked next-state max (DDQN:
  the masked online argmax; C51: the masked argmax of the expected Q)
  gives the same losses and parameters; then the greedy policy acts inside
  the mask."""
  jcls, tcls, categorical = AGENTS[name]
  jnet, params, tnet = _q_networks(categorical=categorical)
  jobs, jact = _full_specs(jspec)
  tobs, tact = _full_specs(tspec)
  extra = dict(min_q_value=-5.0, max_q_value=5.0) if categorical else {}
  jagent = jcls(jts.time_step_spec(jobs), jact, jnet, optax.adam(1e-2),
                observation_and_action_constraint_splitter=_jax_split,
                gamma=0.9, **extra)
  tagent = tcls(tts.time_step_spec(tobs), tact, tnet,
                lambda p: torch.optim.Adam(p, lr=1e-2),
                observation_and_action_constraint_splitter=_torch_split,
                gamma=0.9, device="cpu", **extra)
  jstate = jagent.init(jax.random.key(0))
  jstate = jstate.replace(q_params=params, target_q_params=params,
                          opt_state=jagent.optimizer.init(params))
  tstate = tagent.init()
  jtrain = jax.jit(jagent.train)
  for i, e in enumerate(_experiences(2, seed=9)):
    jstate, jinfo = jtrain(jstate, jtj.Trajectory(
        policy_info=(), **{k: jnp.asarray(v) for k, v in e.items()}))
    tstate, tinfo = tagent.train(tstate, ttj.Trajectory(
        policy_info=(), **{k: torch.from_numpy(v) for k, v in e.items()}))
    assert_close(tinfo.loss, jinfo.loss, err_msg=f"step {i}")
  expect = convert.q_params_to_state_dict(jax.device_get(jstate.q_params))
  for k, v in tstate.q_network.state_dict().items():
    assert_close(v, expect[k], err_msg=k)
  obs = _observations(10)
  jstep, tstep = _steps(obs)
  jaction = jagent.policy.action(jagent.policy_params(jstate), jstep, (),
                                 jax.random.key(0)).action
  taction = tagent.policy.action(tagent.policy_params(tstate), tstep).action
  assert_equal(taction, jaction)
  assert bool(obs[np.arange(B), FEATURES + taction.numpy()].all())
  if categorical:
    assert isinstance(tagent._q_policy, CategoricalQPolicy)


def test_dqn_boltzmann_collect_policy_and_nonzero_minimum():
  """`boltzmann_temperature` makes the collect policy a `BoltzmannPolicy`
  over the Q network alone (not the scheduled params dict); a spec whose
  minimum is not 0 raises, as in the JAX package."""
  jnet, params, tnet = _q_networks()
  tobs = tspec.ArraySpec((FEATURES,), np.float32)
  tact = tspec.BoundedArraySpec((), np.int32, 0, K - 1)
  agent = DqnAgent(tts.time_step_spec(tobs), tact, tnet,
                   lambda p: torch.optim.Adam(p, lr=1e-3),
                   boltzmann_temperature=2.0, device="cpu")
  state = agent.init()
  assert isinstance(agent.collect_policy, BoltzmannPolicy)
  assert agent.collect_policy.temperature == 2.0
  assert agent.collect_policy_params(state) is state.q_network
  step = tts.restart(torch.randn(8, FEATURES), 8)
  action = agent.collect_policy.action(state.q_network, step, (),
                                       Draws(0, "cpu")).action
  assert action.dtype == torch.int32 and int(action.max()) < K
  eps = DqnAgent(tts.time_step_spec(tobs), tact, tnet, torch.optim.Adam,
                 device="cpu")
  assert set(eps.collect_policy_params(eps.init())) == {"q", "train_step"}
  shifted = tspec.BoundedArraySpec((), np.int32, 1, K)
  with pytest.raises(ValueError, match="minimum of 0"):
    DqnAgent(tts.time_step_spec(tobs), shifted, tnet, torch.optim.Adam,
             device="cpu")
  with pytest.raises(ValueError, match="minimum of 0"):
    CategoricalDqnAgent(tts.time_step_spec(tobs), shifted,
                        make_categorical_q_network(tobs, tact, num_atoms=5,
                                                   device="cpu"),
                        torch.optim.Adam, device="cpu")


# -- fixed and scripted policies ----------------------------------------------


def test_fixed_policy_matches_jax():
  """A nest of fixed actions broadcast over the batch (64-bit numbers
  narrowed as JAX narrows them); its distribution is Deterministic."""
  fixed = {"a": np.array([1.5, -0.5], np.float32), "b": 2}
  jspecs = {"a": jspec.ArraySpec((2,), np.float32),
            "b": jspec.ArraySpec((), np.int32)}
  tspecs = {"a": tspec.ArraySpec((2,), np.float32),
            "b": tspec.ArraySpec((), np.int32)}
  obs = np.zeros((5, 3), np.float32)
  jstep, tstep = _steps(obs)
  jpol = jrandom_policy.FixedPolicy(fixed, jts.time_step_spec(
      jspec.ArraySpec((3,), np.float32)), jspecs)
  tpol = FixedPolicy(fixed, tts.time_step_spec(tspec.ArraySpec((3,),
                                                               np.float32)),
                     tspecs)
  jaction = jpol.action((), jstep, (), jax.random.key(0)).action
  taction = tpol.action((), tstep).action
  for k in fixed:
    assert_equal(taction[k], jaction[k])
    assert str(taction[k].dtype).split(".")[-1] == str(jaction[k].dtype)
  td = tpol.distribution((), tstep).action
  assert isinstance(td["a"], dist_lib.Deterministic)
  assert_equal(td["b"].mode(), np.full(5, 2, np.int32))


def test_scripted_policy_matches_jax_and_restarts_at_first_steps():
  """The script's rows in turn, the last one repeated past the end; a row
  whose time step is FIRST starts the script again."""
  script = np.array([[0.0], [1.0], [2.0]], np.float32)
  jpol = jrandom_policy.ScriptedPolicy(
      jts.time_step_spec(jspec.ArraySpec((3,), np.float32)),
      jspec.ArraySpec((1,), np.float32), script)
  tpol = ScriptedPolicy(
      tts.time_step_spec(tspec.ArraySpec((3,), np.float32)),
      tspec.ArraySpec((1,), np.float32), script)
  jstate, tstate = jpol.init_state(2), tpol.init_state(2, device="cpu")
  for t, step_type in enumerate([[0, 0], [1, 1], [1, 0], [1, 1], [1, 1]]):
    st = np.array(step_type, np.int32)
    jstep = jts.TimeStep(step_type=jnp.asarray(st), reward=jnp.zeros(2),
                         discount=jnp.ones(2), observation=jnp.zeros((2, 3)))
    tstep = tts.TimeStep(step_type=torch.from_numpy(st),
                         reward=torch.zeros(2), discount=torch.ones(2),
                         observation=torch.zeros(2, 3))
    jout = jpol.action((), jstep, jstate, jax.random.key(0))
    tout = tpol.action((), tstep, tstate)
    assert_equal(tout.action, jout.action, f"step {t}")
    assert_equal(tout.state, jout.state, f"step {t}")
    jstate, tstate = jout.state, tout.state
  assert_equal(tstate, [5, 3])
  with pytest.raises(NotImplementedError):
    tpol.distribution((), tstep, tstate)
