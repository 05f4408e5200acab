"""Parity helpers for the PyTorch port's tests, and tests of the port's nest
and draw-source utilities.

The port (`agents_tpu_torch`) and the JAX package cannot share random
numbers, so every JAX stochastic site's draws are re-derived here from the
same key splits the JAX package makes, then replayed into the port through
`agents_tpu_torch.utils.draws.ReplayDraws`. Data crosses between the two as
numpy arrays. Float32 comparisons use rtol 1e-5 / atol 1e-6 unless a test
says otherwise.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.classic.catch import Catch as JaxCatch
from agents_tpu.environments.classic.pendulum import Pendulum as JaxPendulum
from agents_tpu.environments.classic.synthetic_pixels import \
    SyntheticPixels as JaxSyntheticPixels
from agents_tpu.specs import array_spec as jax_array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def to_np(x):
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def assert_close(actual, expected, rtol=RTOL, atol=ATOL, err_msg=""):
  np.testing.assert_allclose(to_np(actual), to_np(expected), rtol=rtol,
                             atol=atol, err_msg=err_msg)


def assert_equal(actual, expected, err_msg=""):
  np.testing.assert_array_equal(to_np(actual), to_np(expected),
                                err_msg=err_msg)


# Each JAX environment's draw sites: the (site, read) pairs of its reset
# and of its step (none for a deterministic step), in the order the port
# draws them. `read(state, time_step)` recovers the draw from what the JAX
# function returns.
_ENV_SITES = {
    JaxCartPole: ((("env_reset", lambda s, t: t.observation),), ()),
    JaxSyntheticPixels: ((("pixels_target", lambda s, t: s.target),),
                         (("pixels_step_target", lambda s, t: s.target),)),
    JaxCatch: ((("catch_ball_col", lambda s, t: s.ball_col),), ()),
    JaxPendulum: ((("pendulum_theta", lambda s, t: s.theta),
                   ("pendulum_theta_dot", lambda s, t: s.theta_dot)), ()),
}


def env_reset_site(env):
  """The first reset site of `env`."""
  return _ENV_SITES[type(env)][0][0][0]


def _read_sites(sites, outputs):
  return {site: read(*outputs) for site, read in sites}


def _env_reset_draws(env, keys):
  """{site: [B, ...]}: the draws of `env.reset` vmapped over `keys`."""
  return _read_sites(_ENV_SITES[type(env)][0], jax.vmap(env.reset)(keys))


def _env_step_draws(env, keys):
  """{site: [B, ...]}: the draws of `env.step` vmapped over `keys` (none for
  a deterministic step). The draw depends on the key alone, so the step is
  taken from a reset state with action 0."""
  sites = _ENV_SITES[type(env)][1]
  if not sites:
    return {}
  state, _ = jax.vmap(env.reset)(keys)
  action = jnp.zeros(keys.shape[:1], jnp.int32)
  return _read_sites(sites, jax.vmap(env.step)(state, action, keys))


def jax_env_reset_draws(key, batch_size, env):
  """`BatchedJaxEnv.reset(key)`'s draws: {site: [array [B, ...]]}."""
  draws = _env_reset_draws(env, jax.random.split(key, batch_size))
  return {site: [np.asarray(v)] for site, v in draws.items()}


def jax_env_step_draws(k_env, batch_size, env):
  """`BatchedJaxEnv.step(..., k_env)`'s draws, step and auto-reset
  (jax_environment.py:107-115): {site: [B, ...]}."""
  step_keys, reset_keys = jax.vmap(lambda k: tuple(jax.random.split(k)))(
      jax.random.split(k_env, batch_size))
  return {**_env_step_draws(env, step_keys),
          **_env_reset_draws(env, reset_keys)}


def jax_reset_draws(key, batch_size):
  """CartPole reset draws of `BatchedJaxEnv.reset(key)`: [B, 4]."""
  return jax_env_reset_draws(key, batch_size, JaxCartPole())["env_reset"][0]


def _spec_leaves(spec_nest):
  return jax.tree_util.tree_leaves(
      spec_nest, is_leaf=lambda x: isinstance(x, jax_array_spec.ArraySpec))


def _epsilon_greedy_draws(k_pol, batch_size, action_spec):
  """Epsilon-greedy's random action and coin (wrappers.py:78-125)."""
  _, k_rand, k_mix = jax.random.split(k_pol, 3)
  random_action = jax_array_spec.sample_spec_nest(
      action_spec, k_rand, outer_dims=(batch_size,))
  coin = jax.random.uniform(k_mix, (batch_size,))
  return {"random_action": random_action, "explore": coin}


def _actor_draws(k_pol, batch_size, action_spec):
  """`ActorPolicy`'s normals: the policy key split once per action leaf
  (policy.py:94-97), each leaf's distribution sampling ``[B, *shape]``."""
  leaves = _spec_leaves(action_spec)
  keys = jax.random.split(k_pol, len(leaves))
  return {"actor_noise": [jax.random.normal(k, (batch_size,) + s.shape)
                          for k, s in zip(keys, leaves)]}


def _ppo_draws(k_pol, batch_size, action_spec):
  """`PPOPolicy`'s draws (ppo_policy.py:48-56): the policy key split once
  per action leaf; a continuous leaf draws its normals, a discrete leaf of
  K actions the uniforms in [tiny, 1) of ``jax.random.categorical``'s
  Gumbel noise (``gumbel``'s "low" mode) over ``[B, *shape, K]``."""
  leaves = _spec_leaves(action_spec)
  out = []
  for k, s in zip(jax.random.split(k_pol, len(leaves)), leaves):
    shape = (batch_size,) + s.shape
    if np.issubdtype(s.dtype, np.floating):
      out.append(jax.random.normal(k, shape))
    else:
      k_actions = int(np.max(s.maximum)) - int(np.min(s.minimum)) + 1
      out.append(jax.random.uniform(
          k, shape + (k_actions,), jnp.float32,
          minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
  return {"actor_noise": out}


POLICY_DRAWS = {"epsilon_greedy": _epsilon_greedy_draws,
                "actor": _actor_draws, "ppo": _ppo_draws}


def _collect_step_draws(step_key, batch_size, action_spec, env, policy):
  """One `JaxDriver.run` step's draws: the policy's from `k_pol`
  (jax_driver.py:65) and the env's step and auto-reset draws."""
  k_pol, k_env = jax.random.split(step_key)
  return {**POLICY_DRAWS[policy](k_pol, batch_size, action_spec),
          **jax_env_step_draws(k_env, batch_size, env)}


def _env_step_reset_draws(k_env, batch_size):
  """CartPole's auto-reset draws of one `BatchedJaxEnv.step`: [B, 4]."""
  return jax_env_step_draws(k_env, batch_size, JaxCartPole())["env_reset"]


def _per_step(value):
  """A vmapped draw [n, ...] as n records; a list of them (one per action
  leaf) interleaved step by step, leaf by leaf."""
  if isinstance(value, list):
    return [np.asarray(leaf[t]) for t in range(len(value[0]))
            for leaf in value]
  return list(np.asarray(value))


def jax_collect_draws(key, num_steps, batch_size, action_spec,
                      env=JaxCartPole(), policy="epsilon_greedy"):
  """Per-site draws of `JaxDriver.run(..., key, num_steps)` over `env` with
  an epsilon-greedy, an actor or a PPO collect policy."""
  keys = jax.random.split(key, num_steps)
  draws = jax.vmap(lambda k: _collect_step_draws(
      k, batch_size, action_spec, env, policy))(keys)
  return {site: _per_step(v) for site, v in draws.items()}


def jax_sac_train_draws(train_step, sample_batch_size, action_spec):
  """The normals of `SacAgent.train` at `train_step`: ``fold_in(key(17),
  train_step)`` split into the critic's and the actor's keys
  (sac_agent.py:189-192), each split once per action leaf."""
  key = jax.random.fold_in(jax.random.key(17), train_step)
  leaves = _spec_leaves(action_spec)
  out = {}
  for site, k in zip(("sac_next_action_noise", "sac_action_noise"),
                     jax.random.split(key)):
    out[site] = [np.asarray(jax.random.normal(kk, (sample_batch_size,)
                                              + s.shape))
                 for kk, s in zip(jax.random.split(k, len(leaves)), leaves)]
  return out


def jax_sample_draws(key, sample_batch_size, num_valid, batch_size):
  """`UniformReplay.sample(state, key, ...)`'s draws (uniform_replay.py:164-
  170): the window-start offsets in [0, num_valid) and the rows."""
  k_t, k_b = jax.random.split(key)
  t0 = jax.random.randint(k_t, (sample_batch_size,), 0, jnp.int32(num_valid))
  rows = jax.random.randint(k_b, (sample_batch_size,), 0, batch_size)
  return {"replay_t0": [np.asarray(t0)], "replay_rows": [np.asarray(rows)]}


def jax_eval_draws(key, batch_size, num_steps, env):
  """`JaxEpisodeDriver.run`'s per-step env draws from its loop key
  (jax_driver.py:163-167), for `num_steps` steps: {site: [[B, ...]] * n}."""

  def body(k, _):
    k, _, k_env = jax.random.split(k, 3)
    return k, jax_env_step_draws(k_env, batch_size, env)

  _, draws = jax.lax.scan(body, key, None, length=num_steps)
  return {site: list(np.asarray(v)) for site, v in draws.items()}


def jax_eval_reset_draws(key, batch_size, num_steps):
  """CartPole's per-step reset draws of `JaxEpisodeDriver.run`:
  [num_steps, B, 4]."""
  return jax_eval_draws(key, batch_size, num_steps, JaxCartPole())[
      "env_reset"]


def merge_draws(*records):
  out = {}
  for rec in records:
    for site, values in rec.items():
      out.setdefault(site, []).extend(values)
  return out


# -- tests of the port's nest and draw utilities ----------------------------

@dataclasses.dataclass(frozen=True)
class _Pair:
  a: object
  b: object


class _Named(NamedTuple):
  x: object
  y: object


def test_tree_map_over_dataclass_namedtuple_dict_and_empty_nodes():
  tree = _Pair(a=_Named(x=1, y=[2, 3]), b={"k": 4, "e": ()})
  out = nest_utils.tree_map(lambda v, w: v * 10 + w, tree, tree)
  assert out == _Pair(a=_Named(x=11, y=[22, 33]), b={"k": 44, "e": ()})
  assert nest_utils.flatten(tree) == [1, 2, 3, 4]


def test_where_broadcasts_condition_over_inner_dims():
  cond = torch.tensor([True, False])
  t = {"v": torch.ones(2, 3), "s": torch.ones(2)}
  f = {"v": torch.zeros(2, 3), "s": torch.zeros(2)}
  out = nest_utils.where(cond, t, f)
  assert_equal(out["v"], [[1, 1, 1], [0, 0, 0]])
  assert_equal(out["s"], [1, 0])


def test_replay_draws_check_shape_and_run_dry():
  draws = ReplayDraws({"s": [np.arange(3)]})
  assert_equal(draws.randint("s", (3,), 0, 5), [0, 1, 2])
  with pytest.raises(LookupError):
    draws.randint("s", (3,), 0, 5)
  with pytest.raises(ValueError):
    ReplayDraws({"s": [np.arange(3)]}).uniform("s", (4,))


def test_recorded_draws_replay_identically():
  rec = RecordingDraws(Draws(3, "cpu"))
  first = [rec.uniform("u", (4,), -1.0, 1.0), rec.randint("i", (5,), 0, 7)]
  replay = ReplayDraws(rec.records)
  assert_equal(replay.uniform("u", (4,)), first[0])
  assert_equal(replay.randint("i", (5,), 0, 7), first[1])
  u = first[0]
  assert bool(((u >= -1.0) & (u < 1.0)).all())
