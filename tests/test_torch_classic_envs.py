"""Port parity: Acrobot, MountainCar and ContinuousMountainCar
(`agents_tpu_torch.environments.classic`) against the JAX package's and
against gymnasium, the port's counterparts of `tests/test_classic_envs.py`.

Each environment is rolled out in B lockstep rows with random actions and
short time limits, so every row crosses auto-resets; the JAX side's reset
draws are replayed into the port. Each step starts from the JAX side's
state, since Acrobot's RK4 swing is chaotic and an ulp of `sin` would grow
over an episode: step types, step counts and discounts agree exactly,
observations, physics and rewards to rtol 1e-5 / atol 1e-5. MountainCar
is not chaotic, and its whole rollout agrees as one run too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.environments.classic.acrobot import Acrobot as JaxAcrobot
from agents_tpu.environments.classic.mountain_car import (
    ContinuousMountainCar as JaxContinuousMountainCar)
from agents_tpu.environments.classic.mountain_car import \
    MountainCar as JaxMountainCar
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import (Acrobot,
                                                   ContinuousMountainCar,
                                                   MountainCar)
from agents_tpu_torch.environments.classic.acrobot import AcrobotState
from agents_tpu_torch.environments.classic.mountain_car import \
    MountainCarState
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     env_reset_site, jax_env_reset_draws,
                                     jax_env_step_draws, merge_draws)

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
B, STEPS = 6, 200
ENVS = {
    "acrobot": (lambda: JaxAcrobot(max_episode_steps=30),
                lambda: Acrobot(max_episode_steps=30), AcrobotState),
    "mountain_car": (lambda: JaxMountainCar(max_episode_steps=40),
                     lambda: MountainCar(max_episode_steps=40),
                     MountainCarState),
    "continuous_mountain_car": (
        lambda: JaxContinuousMountainCar(max_episode_steps=40),
        lambda: ContinuousMountainCar(max_episode_steps=40),
        MountainCarState)}


def _actions(spec, rng, steps):
  if np.issubdtype(spec.dtype, np.integer):
    return rng.randint(0, 3, (steps, B)).astype(np.int32)
  # Beyond the bounds too: the dynamics clip, the penalty takes the raw
  # action.
  return rng.uniform(-1.5, 1.5, (steps, B) + spec.shape).astype(np.float32)


def _torch_state(state_cls, jstate):
  return state_cls(**{f: torch.from_numpy(np.array(getattr(jstate, f)))
                      for f in ("physics", "steps", "terminated")})


def _torch_time_step(jstep):
  return tts.TimeStep(**{f: torch.from_numpy(np.array(getattr(jstep, f)))
                         for f in ("step_type", "reward", "discount",
                                   "observation")})


def _jax_rollout(jenv, actions, key):
  """(states, time steps, per-step keys) of a JAX rollout from `key`."""
  k_reset, k_run = jax.random.split(key)
  state, step = jenv.reset(k_reset)
  step_fn = jax.jit(jenv.step)
  states, steps, keys = [state], [step], jax.random.split(k_run, len(actions))
  for a, k in zip(actions, keys):
    state, step = step_fn(state, step, jnp.asarray(a), k)
    states.append(state)
    steps.append(step)
  return k_reset, states, steps, keys


def _compare(tstate, tstep, jstate, jstep, msg):
  assert_close(tstep.observation, jstep.observation, RTOL, ATOL, msg)
  assert_close(tstep.reward, jstep.reward, RTOL, ATOL, msg)
  assert_close(tstate.physics, jstate.physics, RTOL, ATOL, msg)
  assert_equal(tstep.step_type, jstep.step_type, msg)
  assert_equal(tstep.discount, jstep.discount, msg)
  assert_equal(tstate.steps, jstate.steps, msg)
  assert_equal(tstate.terminated, jstate.terminated, msg)


@pytest.mark.parametrize("name", list(ENVS))
def test_steps_match_jax_over_auto_resets(name):
  jctor, tctor, state_cls = ENVS[name]
  jenv = BatchedJaxEnv(jctor(), batch_size=B)
  tenv = BatchedTorchEnv(tctor(), B, device="cpu")
  actions = _actions(tenv.action_spec(), np.random.RandomState(1), STEPS)
  k_reset, jstates, jsteps, keys = _jax_rollout(jenv, actions,
                                                jax.random.key(2))
  draws = ReplayDraws(jax_env_reset_draws(k_reset, B, jenv.env))
  tstate, tstep = tenv.reset(draws)
  _compare(tstate, tstep, jstates[0], jsteps[0], "reset")
  for t, (a, k) in enumerate(zip(actions, keys)):
    draws = ReplayDraws({site: [v] for site, v in jax_env_step_draws(
        k, B, jenv.env).items()})
    tstate, tstep = tenv.step(_torch_state(state_cls, jstates[t]),
                              _torch_time_step(jsteps[t]),
                              torch.from_numpy(a), draws)
    _compare(tstate, tstep, jstates[t + 1], jsteps[t + 1], f"step {t}")
  types = np.stack([np.asarray(s.step_type) for s in jsteps])
  assert (types == StepType.LAST).sum() >= B
  lasts = np.argwhere(types[:-1] == StepType.LAST)
  assert all(types[t + 1, b] == StepType.FIRST for t, b in lasts)


@pytest.mark.parametrize("name", ["mountain_car", "continuous_mountain_car"])
def test_mountain_car_rollout_matches_jax_as_one_run(name):
  jctor, tctor, _ = ENVS[name]
  jenv = BatchedJaxEnv(jctor(), batch_size=B)
  tenv = BatchedTorchEnv(tctor(), B, device="cpu")
  actions = _actions(tenv.action_spec(), np.random.RandomState(4), STEPS)
  k_reset, jstates, jsteps, keys = _jax_rollout(jenv, actions,
                                                jax.random.key(5))
  draws = ReplayDraws(merge_draws(
      jax_env_reset_draws(k_reset, B, jenv.env),
      *({site: [v] for site, v in jax_env_step_draws(k, B, jenv.env).items()}
        for k in keys)))
  tstate, tstep = tenv.reset(draws)
  for t, a in enumerate(actions):
    tstate, tstep = tenv.step(tstate, tstep, torch.from_numpy(a), draws)
    _compare(tstate, tstep, jstates[t + 1], jsteps[t + 1], f"step {t}")
  assert all(v == 0 for v in draws.remaining().values())


@pytest.mark.parametrize("name", list(ENVS))
def test_specs_and_reset_site_match_jax(name):
  jctor, tctor, _ = ENVS[name]
  jenv, tenv = jctor(), tctor()
  for j, t in ((jenv.observation_spec(), tenv.observation_spec()),
               (jenv.action_spec(), tenv.action_spec())):
    assert t.shape == j.shape and t.dtype == j.dtype and t.name == j.name
    assert_equal(np.broadcast_to(t.minimum, t.shape),
                 np.broadcast_to(j.minimum, j.shape))
    assert_equal(np.broadcast_to(t.maximum, t.shape),
                 np.broadcast_to(j.maximum, j.shape))
  assert env_reset_site(jenv) == {"acrobot": "acrobot_physics"}.get(
      name, "mountain_car_position")
  state, step = tenv.reset(Draws(0, "cpu"), 64)
  low = -0.1 if name == "acrobot" else -0.6
  high = 0.1 if name == "acrobot" else -0.4
  first = state.physics if name == "acrobot" else state.physics[:, 0]
  assert bool(((first >= low) & (first < high)).all())
  assert bool((step.step_type == StepType.FIRST).all())


def test_mountain_car_termination_semantics():
  """The goal emits LAST with discount 0, the time limit LAST with 1."""
  env = MountainCar(max_episode_steps=5)
  state, step = env.reset(Draws(0, "cpu"), 2)
  for _ in range(5):
    state, step = env.step(state, torch.ones(2, dtype=torch.int32))
  assert bool((step.step_type == StepType.LAST).all())
  assert bool((step.discount == 1.0).all())
  state, _ = MountainCar().reset(Draws(0, "cpu"), 2)
  state = MountainCarState(physics=torch.tensor([[0.49, 0.07]] * 2),
                           steps=state.steps, terminated=state.terminated)
  state, step = MountainCar().step(state, torch.full((2,), 2,
                                                     dtype=torch.int32))
  assert bool((step.step_type == StepType.LAST).all())
  assert bool((step.discount == 0.0).all())


# -- against gymnasium --------------------------------------------------------


def _rollout_torch(env, state, actions):
  obs, rewards = [], []
  for a in actions:
    state, step = env.step(state, torch.as_tensor(np.asarray(a))[None])
    obs.append(step.observation[0].numpy())
    rewards.append(float(step.reward[0]))
    if int(step.step_type[0]) == int(StepType.LAST):
      break
  return obs, rewards


def _rollout_gym(gym_env, start_state, actions):
  gym_env.reset(seed=0)
  gym_env.unwrapped.state = start_state
  obs, rewards = [], []
  for a in actions:
    o, r, term, trunc, _ = gym_env.step(a)
    obs.append(np.asarray(o))
    rewards.append(float(r))
    if term or trunc:
      break
  return obs, rewards


@pytest.mark.parametrize("name,gym_id,seed", [
    ("mountain_car", "MountainCar-v0", 0),
    ("continuous_mountain_car", "MountainCarContinuous-v0", 1),
    ("acrobot", "Acrobot-v1", 3)])
def test_matches_gymnasium(name, gym_id, seed):
  """Float32 against gymnasium's float64: MountainCar to atol 1e-5,
  Acrobot's RK4 to 2e-3 over 80 steps (as the JAX package's tests)."""
  gym = pytest.importorskip("gymnasium")
  env = {"acrobot": Acrobot, "mountain_car": MountainCar,
         "continuous_mountain_car": ContinuousMountainCar}[name]()
  state, _ = env.reset(Draws(seed, "cpu"), 1)
  start = state.physics[0].double().numpy()
  rng = np.random.RandomState(seed)
  if name == "continuous_mountain_car":
    actions = [np.asarray([a], np.float32) for a in rng.uniform(-1, 1, 60)]
  else:
    actions = rng.randint(0, 3, size=80 if name == "acrobot" else 60).astype(
        np.int32).tolist()
  tobs, trew = _rollout_torch(env, state, actions)
  gobs, grew = _rollout_gym(gym.make(gym_id), start, actions)
  tol = dict(rtol=2e-3, atol=2e-3) if name == "acrobot" else dict(atol=1e-5)
  for to, go in zip(tobs, gobs):
    np.testing.assert_allclose(to, go, **tol)
  np.testing.assert_allclose(trew[:len(grew)], grew, atol=1e-5)
