"""Port parity: CartPole and the batched auto-reset env
(`agents_tpu_torch.environments`) against the JAX package, step by step.

The JAX side's reset draws are read back from its own key splits
(`test_torch_parity_utils`) and replayed into the port. Observations are
compared with rtol 1e-5 / atol 1e-6: `sin`, `cos` and the squares may
differ from XLA's by an ulp, and over 40 steps that stays far inside the
tolerance. Step types and discounts are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.classic.cartpole import \
    CartPoleState as JaxCartPoleState
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.environments.classic.cartpole import CartPoleState
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (_env_step_reset_draws, assert_close,
                                     assert_equal, jax_reset_draws)

torch.set_num_threads(1)


def test_cartpole_step_matches_jax_on_random_states():
  """One unbatched-dynamics step from 256 random states, some past the
  thresholds and some at the time limit."""
  rng = np.random.RandomState(0)
  b = 256
  physics = (rng.randn(b, 4) * [1.5, 1.0, 0.15, 1.0]).astype(np.float32)
  steps = rng.randint(190, 200, size=b).astype(np.int32)
  action = rng.randint(0, 2, size=b).astype(np.int32)

  jstate = JaxCartPoleState(physics=jnp.asarray(physics),
                            steps=jnp.asarray(steps),
                            terminated=jnp.zeros(b, bool))
  jnext, jts = jax.vmap(JaxCartPole().step)(
      jstate, jnp.asarray(action), jax.random.split(jax.random.key(0), b))
  tstate = CartPoleState(physics=torch.from_numpy(physics),
                         steps=torch.from_numpy(steps),
                         terminated=torch.zeros(b, dtype=torch.bool))
  tnext, tts = CartPole().step(tstate, torch.from_numpy(action))

  assert_close(tts.observation, jts.observation)
  assert_equal(tts.step_type, jts.step_type)
  assert_equal(tts.discount, jts.discount)
  assert_equal(tts.reward, jts.reward)
  assert_equal(tnext.steps, jnext.steps)
  assert_equal(tnext.terminated, jnext.terminated)
  # Both kinds of LAST occur: termination (discount 0), truncation (1).
  last = np.asarray(jts.step_type) == StepType.LAST
  assert (np.asarray(jts.discount)[last] == 0.0).any()
  assert (np.asarray(jts.discount)[last] == 1.0).any()
  assert tts.observation.dtype == torch.float32


def test_batched_auto_reset_matches_jax_step_by_step():
  """40 lockstep steps at B=6 with a 12-step time limit. Rows 0-2 always
  push right and their poles fall (termination); rows 3-5 alternate and
  hit the time limit (truncation). The action given on a LAST step is
  discarded and the row restarts from its reset draw."""
  b, t_steps, limit = 6, 40, 12
  key = jax.random.key(3)
  k_reset, k_run = jax.random.split(key)
  jenv = BatchedJaxEnv(JaxCartPole(max_episode_steps=limit), batch_size=b)
  jstep = jax.jit(jenv.step)
  jstate, jts = jenv.reset(k_reset)

  step_keys = jax.random.split(k_run, t_steps)
  records = {"env_reset": [jax_reset_draws(k_reset, b)] + [
      np.asarray(_env_step_reset_draws(k, b)) for k in step_keys]}
  draws = ReplayDraws(records)
  tenv = BatchedTorchEnv(CartPole(max_episode_steps=limit), b, device="cpu")
  tstate, tts = tenv.reset(draws)
  assert_close(tts.observation, jts.observation)
  assert_equal(tts.step_type, jts.step_type)

  seen_discounts_at_last = set()
  rng = np.random.RandomState(1)
  for t in range(t_steps):
    action = np.where(np.arange(b) < 3, 1, t % 2).astype(np.int32)
    # Random actions on the steps where the previous step was LAST: they
    # must be discarded on both sides.
    prev_last = np.asarray(jts.step_type) == StepType.LAST
    action = np.where(prev_last, rng.randint(0, 2, b), action).astype(
        np.int32)
    jstate, jts = jstep(jstate, jts, jnp.asarray(action), step_keys[t])
    tstate, tts = tenv.step(tstate, tts, torch.from_numpy(action), draws)
    msg = f"step {t}"
    assert_equal(tts.step_type, jts.step_type, msg)
    assert_equal(tts.discount, jts.discount, msg)
    assert_equal(tts.reward, jts.reward, msg)
    assert_close(tts.observation, jts.observation, err_msg=msg)
    assert_equal(tstate.steps, jstate.steps, msg)
    last = np.asarray(jts.step_type) == StepType.LAST
    seen_discounts_at_last |= set(np.asarray(jts.discount)[last].tolist())
    # Rows whose previous step was LAST are FIRST now.
    assert (np.asarray(jts.step_type)[prev_last] == StepType.FIRST).all()
  assert seen_discounts_at_last == {0.0, 1.0}
  assert draws.remaining() == {"env_reset": 0}


def test_batched_env_draws_resets_for_every_row_every_step():
  """Reset draws are made for all B rows on every step, as in the JAX
  package, so a replayed stream stays aligned whatever rows reset."""
  b = 3
  records = {"env_reset": [np.zeros((b, 4), np.float32)] * 4}
  draws = ReplayDraws(records)
  env = BatchedTorchEnv(CartPole(), b, device="cpu")
  state, ts = env.reset(draws)
  for _ in range(3):
    state, ts = env.step(state, ts, torch.ones(b, dtype=torch.int32), draws)
  assert draws.remaining() == {"env_reset": 0}
  assert env.time_step_spec().observation.shape == (4,)
  assert env.action_spec().num_values == 2
