"""Port parity: the on-device Pendulum (`agents_tpu_torch.environments.
classic.Pendulum`) against the JAX package's.

One step from 256 random states and actions agrees to float32 rounding
(rtol 1e-5 / atol 1e-5: `sin`/`cos` may differ from XLA's by an ulp).
The 210-step rollout crosses an auto-reset with the JAX side's reset draws
replayed into the port; step types and discounts agree exactly, and the
observations and rewards to atol 1e-3 / rtol 1e-4: the swing is chaotic,
so one-ulp differences in `sin` grow over the 200 steps of an episode
(the largest difference on this test's rollout is 1.7e-4, on a reward
near -10; a failure prints the largest so far).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from agents_tpu.environments.classic.pendulum import Pendulum as JaxPendulum
from agents_tpu.environments.classic.pendulum import \
    PendulumState as JaxPendulumState
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import Pendulum
from agents_tpu_torch.environments.classic.pendulum import PendulumState
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     env_reset_site, jax_env_reset_draws,
                                     jax_env_step_draws, merge_draws)

torch.set_num_threads(1)

STEP_RTOL = STEP_ATOL = 1e-5
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-3


def test_specs_match_jax():
  jenv, tenv = JaxPendulum(), Pendulum()
  for jspec, tspec in ((jenv.observation_spec(), tenv.observation_spec()),
                       (jenv.action_spec(), tenv.action_spec())):
    assert tspec.shape == jspec.shape and tspec.dtype == jspec.dtype
    assert_equal(np.broadcast_to(tspec.minimum, tspec.shape),
                 np.broadcast_to(jspec.minimum, jspec.shape))
    assert_equal(np.broadcast_to(tspec.maximum, tspec.shape),
                 np.broadcast_to(jspec.maximum, jspec.shape))
  assert tenv.action_spec().shape == (1,)
  assert tenv.time_step_spec().reward.shape == ()
  assert env_reset_site(jenv) == "pendulum_theta"


def test_step_matches_jax_on_random_states():
  """Angles beyond ±2π exercise `_angle_normalize` on both signs, actions
  beyond ±2 the torque clip, speeds near ±8 the speed clip, and step
  counts 199 the truncation."""
  rng = np.random.RandomState(0)
  b = 256
  theta = rng.uniform(-3 * math.pi, 3 * math.pi, b).astype(np.float32)
  theta_dot = rng.uniform(-8.0, 8.0, b).astype(np.float32)
  steps = np.where(rng.rand(b) < 0.3, 199, rng.randint(0, 199, b)).astype(
      np.int32)
  action = rng.uniform(-3.0, 3.0, (b, 1)).astype(np.float32)
  jnext, jts = jax.vmap(JaxPendulum().step)(
      JaxPendulumState(theta=jnp.asarray(theta),
                       theta_dot=jnp.asarray(theta_dot),
                       steps=jnp.asarray(steps)),
      jnp.asarray(action), jax.random.split(jax.random.key(0), b))
  tnext, tts = Pendulum().step(
      PendulumState(theta=torch.from_numpy(theta),
                    theta_dot=torch.from_numpy(theta_dot),
                    steps=torch.from_numpy(steps)),
      torch.from_numpy(action))
  for field in ("observation", "reward"):
    assert_close(getattr(tts, field), getattr(jts, field), STEP_RTOL,
                 STEP_ATOL, field)
  for field in ("theta", "theta_dot"):
    assert_close(getattr(tnext, field), getattr(jnext, field), STEP_RTOL,
                 STEP_ATOL, field)
  assert_equal(tnext.steps, jnext.steps)
  assert_equal(tts.step_type, jts.step_type)
  assert_equal(tts.discount, jts.discount)
  assert (tts.step_type == StepType.LAST).sum() > 50
  assert tts.observation.dtype == torch.float32
  assert tts.reward.dtype == torch.float32


def test_rollout_matches_jax_over_an_auto_reset():
  b, steps = 6, 210
  key = jax.random.key(3)
  k_reset, k_run = jax.random.split(key)
  step_keys = jax.random.split(k_run, steps)
  jenv1 = JaxPendulum()
  jenv = BatchedJaxEnv(jenv1, batch_size=b)
  jstep = jax.jit(jenv.step)
  jstate, jts = jenv.reset(k_reset)
  draws = ReplayDraws(merge_draws(
      jax_env_reset_draws(k_reset, b, jenv1),
      *({site: [np.asarray(v)] for site, v in
         jax_env_step_draws(k, b, jenv1).items()} for k in step_keys)))
  tenv = BatchedTorchEnv(Pendulum(), b, device="cpu")
  tstate, tts = tenv.reset(draws)
  assert_close(tts.observation, jts.observation, STEP_RTOL, STEP_ATOL)

  rng = np.random.RandomState(1)
  worst = 0.0
  for t in range(steps):
    action = rng.uniform(-2.5, 2.5, (b, 1)).astype(np.float32)
    prev_last = np.asarray(jts.step_type) == StepType.LAST
    jstate, jts = jstep(jstate, jts, jnp.asarray(action), step_keys[t])
    tstate, tts = tenv.step(tstate, tts, torch.from_numpy(action), draws)
    assert_equal(tts.step_type, jts.step_type, f"step {t}")
    assert_equal(tts.discount, jts.discount, f"step {t}")
    for field in ("observation", "reward"):
      a, e = getattr(tts, field).numpy(), np.asarray(getattr(jts, field))
      worst = max(worst, float(np.abs(a - e).max()))
      assert_close(a, e, ROLLOUT_RTOL, ROLLOUT_ATOL,
                   f"step {t} {field} (largest so far {worst})")
    if prev_last.any():
      # Restarted rows take the replayed reset draws exactly.
      assert (np.asarray(jts.step_type)[prev_last] == StepType.FIRST).all()
      assert_close(tts.observation[prev_last],
                   np.asarray(jts.observation)[prev_last], STEP_RTOL,
                   STEP_ATOL)
  assert int(tstate.steps.max()) == steps - 201
  assert all(v == 0 for v in draws.remaining().values())


def test_reset_draws_in_range_and_deterministic_step():
  env = BatchedTorchEnv(Pendulum(max_episode_steps=3), 512, device="cpu")
  state, ts = env.reset(Draws(0, "cpu"))
  assert ((state.theta >= -math.pi) & (state.theta < math.pi)).all()
  assert ((state.theta_dot >= -1.0) & (state.theta_dot < 1.0)).all()
  assert_close(ts.observation[:, 0], torch.cos(state.theta))
  action = torch.full((512, 1), 0.5)
  _, t1 = env.env.step(state, action)
  _, t2 = env.env.step(state, action)
  assert_equal(t1.observation, t2.observation)
  for _ in range(3):
    state, ts = env.env.step(state, action)
  assert (ts.step_type == StepType.LAST).all()
  assert (ts.discount == 1.0).all()
