"""Port parity: the pixel environments (`SyntheticPixels`, `Catch` of
`agents_tpu_torch.environments.classic`) against the JAX package, step by
step with auto-reset.

The JAX side's reset and step draws are read back from its own key splits
(`test_torch_parity_utils.jax_env_reset_draws`, `jax_env_step_draws`) and
replayed into the port. Everything is integer or exact float arithmetic,
so observations (uint8 and float32), rewards, step types and discounts
are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.environments.classic.catch import Catch as JaxCatch
from agents_tpu.environments.classic.catch import CatchState as JaxCatchState
from agents_tpu.environments.classic.synthetic_pixels import \
    SyntheticPixels as JaxSyntheticPixels
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import Catch, SyntheticPixels
from agents_tpu_torch.environments.classic.catch import CatchState
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import (assert_equal, jax_env_reset_draws,
                                     jax_env_step_draws, merge_draws)

torch.set_num_threads(1)

# (JAX env, port env, B, steps): each run covers two episodes and more.
ENVS = {
    "pixels": (JaxSyntheticPixels(size=12, frames=2, num_actions=4,
                                  horizon=5),
               SyntheticPixels(size=12, frames=2, num_actions=4, horizon=5),
               3, 13),
    "catch": (JaxCatch(rows=5, columns=3), Catch(rows=5, columns=3), 4, 11),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_matches_jax_over_two_episodes_with_auto_reset(name):
  jenv1, tenv1, b, steps = ENVS[name]
  assert tenv1.observation_spec().shape == jenv1.observation_spec().shape
  assert tenv1.observation_spec().dtype == jenv1.observation_spec().dtype
  assert tenv1.action_spec().num_values == jenv1.action_spec().num_values
  key = jax.random.key(5)
  k_reset, k_run = jax.random.split(key)
  step_keys = jax.random.split(k_run, steps)
  jenv = BatchedJaxEnv(jenv1, batch_size=b)
  jstep = jax.jit(jenv.step)
  jstate, jts = jenv.reset(k_reset)
  draws = ReplayDraws(merge_draws(
      jax_env_reset_draws(k_reset, b, jenv1),
      *({site: [np.asarray(v)] for site, v in
         jax_env_step_draws(k, b, jenv1).items()} for k in step_keys)))
  tenv = BatchedTorchEnv(tenv1, b, device="cpu")
  tstate, tts = tenv.reset(draws)
  assert_equal(tts.observation, jts.observation)
  assert tts.observation.numpy().dtype == np.asarray(jts.observation).dtype

  rng = np.random.RandomState(2)
  lasts = 0
  for t in range(steps):
    action = rng.randint(0, jenv1.action_spec().num_values, b).astype(
        np.int32)
    prev_last = np.asarray(jts.step_type) == StepType.LAST
    jstate, jts = jstep(jstate, jts, jnp.asarray(action), step_keys[t])
    tstate, tts = tenv.step(tstate, tts, torch.from_numpy(action), draws)
    for field in ("observation", "reward", "step_type", "discount"):
      assert_equal(getattr(tts, field), getattr(jts, field),
                   f"step {t} {field}")
    assert (np.asarray(jts.step_type)[prev_last] == StepType.FIRST).all()
    lasts += int((np.asarray(jts.step_type) == StepType.LAST).sum())
  assert lasts >= 2 * b   # every row ended at least two episodes
  assert all(v == 0 for v in draws.remaining().values())


def test_catch_step_matches_jax_on_random_states():
  rng = np.random.RandomState(0)
  b, rows, cols = 128, 6, 5
  # Half the rows are one step from the bottom, so both rewards occur.
  fields = dict(ball_row=np.where(rng.rand(b) < 0.5, rows - 2,
                                  rng.randint(0, rows - 1, b)),
                ball_col=rng.randint(0, cols, b),
                paddle_col=rng.randint(0, cols, b))
  action = rng.randint(0, 3, b).astype(np.int32)
  jnext, jts = jax.vmap(JaxCatch(rows, cols).step)(
      JaxCatchState(**{k: jnp.asarray(v, jnp.int32)
                       for k, v in fields.items()}),
      jnp.asarray(action), jax.random.split(jax.random.key(0), b))
  tnext, tts = Catch(rows, cols).step(
      CatchState(**{k: torch.from_numpy(v.astype(np.int32))
                    for k, v in fields.items()}), torch.from_numpy(action))
  for field in ("observation", "reward", "step_type", "discount"):
    assert_equal(getattr(tts, field), getattr(jts, field), field)
  for field in ("ball_row", "ball_col", "paddle_col"):
    assert_equal(getattr(tnext, field), getattr(jnext, field), field)
  assert set(np.asarray(jts.reward).tolist()) == {-1.0, 0.0, 1.0}


def test_synthetic_pixels_specs_and_stepping():
  """Twin of `tests/test_synthetic_pixels.py::test_specs_and_stepping`."""
  env = BatchedTorchEnv(SyntheticPixels(size=12, frames=2, num_actions=4,
                                        horizon=5), 3, device="cpu")
  draws = Draws(0, "cpu")
  state, ts0 = env.reset(draws)
  assert tuple(ts0.observation.shape) == (3, 12, 12, 2)
  assert ts0.observation.dtype == torch.uint8
  tstep = ts0
  for i in range(6):
    a = torch.full((3,), i % 4, dtype=torch.int32)
    state, tstep = env.step(state, tstep, a, draws)
  obs = tstep.observation.numpy()
  assert obs.min() >= 0 and obs.max() <= 250
  assert env.observation_spec().shape == (12, 12, 2)


def test_catch_env_mechanics():
  """Twin of `tests/test_catch_conv_e2e.py::test_catch_env_mechanics`."""
  env = Catch(rows=5, columns=3)
  state, step = env.reset(Draws(3, "cpu"), 1)
  assert tuple(step.observation.shape) == (1, 5, 3, 1)
  assert float(step.observation.sum()) == 2.0  # ball + paddle
  rewards = []
  for _ in range(4):
    state, step = env.step(state, torch.ones(1, dtype=torch.int32))
    rewards.append(float(step.reward[0]))
  assert int(step.step_type[0]) == 2 and float(step.discount[0]) == 0.0
  assert rewards[:-1] == [0.0, 0.0, 0.0] and rewards[-1] in (-1.0, 1.0)


def test_catch_perfect_policy_catches():
  """Twin of `tests/test_catch_conv_e2e.py::
  test_catch_perfect_policy_catches`, on every starting column."""
  env = Catch(rows=6, columns=5)
  draws = ReplayDraws({"catch_ball_col": [np.arange(5, dtype=np.int32)]})
  state, step = env.reset(draws, 5)
  for _ in range(5):
    action = torch.sign(state.ball_col - state.paddle_col) + 1
    state, step = env.step(state, action.to(torch.int32))
  assert_equal(step.reward, np.ones(5, np.float32))
  assert_equal(step.step_type, np.full(5, StepType.LAST, np.int32))
