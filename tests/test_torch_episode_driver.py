"""Port parity: the exact-episode driver's masking of finished rows
(`agents_tpu_torch.drivers.TorchEpisodeDriver`) against the JAX package's
`JaxEpisodeDriver`, for a scalar, a vector and a dict reward.

Three rows run 3-step episodes of a counting environment until 4 episodes
have ended: row 0 has a quota of 2, rows 1 and 2 of 1. Once a row has met
its quota the driver rewrites its frames as boundary frames with zero
reward and discount, before the observers see them. The reward of a
``[B, K]`` vector leaf (here B = K = 3) or of each dict leaf must be
zeroed by row, as `jax_driver.py:139-154` reshapes the row mask to each
leaf's rank. An observer sums the masked rewards and discounts and counts
the frames that end an episode (next step LAST) per row; the sums agree
to rtol 1e-5 / atol 1e-6 and the counts exactly. The rows start from reset values drawn on the JAX side and
replayed into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

import test_torch_parity_utils
from agents_tpu.drivers.jax_driver import JaxEpisodeDriver
from agents_tpu.environments.jax_environment import (BatchedJaxEnv,
                                                     JaxEnvironment)
from agents_tpu.policies.random_policy import FixedPolicy as JaxFixedPolicy
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.drivers import TorchEpisodeDriver
from agents_tpu_torch.environments import BatchedTorchEnv, TorchEnvironment
from agents_tpu_torch.policies import FixedPolicy
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_env_reset_draws, jax_eval_draws,
                                     merge_draws)

torch.set_num_threads(1)

B, EPISODE, NUM_EPISODES, MAX_STEPS = 3, 3, 4, 64
WEIGHTS = np.array([1.0, 2.0, 3.0], np.float32)


def _reward_spec(module, kind):
  if kind == "scalar":
    return module.ArraySpec((), np.float32)
  if kind == "vector":
    return module.ArraySpec((3,), np.float32)
  return {"b": module.ArraySpec((2,), np.float32),
          "a": module.ArraySpec((), np.float32)}


def _reward(kind, v, steps, xp):
  """The reward of rows with reset values `v` after `steps` steps."""
  s = steps.astype(v.dtype) if xp is jnp else steps.to(v.dtype)
  if kind == "scalar":
    return v + s
  if kind == "vector":
    return v[..., None] * xp.asarray(WEIGHTS) + s[..., None]
  return {"b": xp.stack([v - s, 2 * v + s], -1), "a": 10 * v + s}


@struct.dataclass
class _JaxCountingState:
  v: jax.Array
  steps: jax.Array


class JaxCountingEnv(JaxEnvironment):
  """One row: a value v drawn at reset, 3-step episodes, reward of v and
  the step count."""

  def __init__(self, kind):
    self.kind = kind

  def observation_spec(self):
    return jspec.ArraySpec((1,), np.float32)

  def action_spec(self):
    return jspec.BoundedArraySpec((), np.int32, 0, 1)

  def reward_spec(self):
    return _reward_spec(jspec, self.kind)

  def reset(self, key):
    v = jax.random.uniform(key, (), jnp.float32, 1.0, 2.0)
    return (_JaxCountingState(v=v, steps=jnp.zeros((), jnp.int32)),
            jts.restart(v[None], reward_spec=self.reward_spec()))

  def step(self, state, action, key):
    steps = state.steps + 1
    step_type = jnp.where(steps >= EPISODE, jts.StepType.LAST,
                          jts.StepType.MID).astype(jnp.int32)
    return (_JaxCountingState(v=state.v, steps=steps),
            jts.TimeStep(step_type=step_type,
                         reward=_reward(self.kind, state.v, steps, jnp),
                         discount=jnp.ones((), jnp.float32),
                         observation=state.v[None]))


@dataclasses.dataclass(frozen=True)
class _CountingState:
  v: torch.Tensor
  steps: torch.Tensor


class CountingEnv(TorchEnvironment):
  """`JaxCountingEnv` over [B] rows; its reset draws "count_reset"."""

  def __init__(self, kind):
    self.kind = kind

  def observation_spec(self):
    return tspec.ArraySpec((1,), np.float32)

  def action_spec(self):
    return tspec.BoundedArraySpec((), np.int32, 0, 1)

  def reward_spec(self):
    return _reward_spec(tspec, self.kind)

  def reset(self, draws, batch_size):
    v = draws.uniform("count_reset", (batch_size,), 1.0, 2.0)
    step = tts.restart(v[:, None], batch_size)
    reward = tspec.zero_spec_nest(self.reward_spec(), (batch_size,))
    return (_CountingState(v=v, steps=torch.zeros(batch_size,
                                                  dtype=torch.int32)),
            dataclasses.replace(step, reward=reward))

  def step(self, state, action, draws=None):
    steps = state.steps + 1
    step_type = torch.where(steps >= EPISODE, tts.StepType.LAST,
                            tts.StepType.MID).to(torch.int32)
    return (_CountingState(v=state.v, steps=steps),
            tts.TimeStep(step_type=step_type,
                         reward=_reward(self.kind, state.v, steps, torch),
                         discount=torch.ones_like(state.v),
                         observation=state.v[:, None]))


test_torch_parity_utils._ENV_SITES[JaxCountingEnv] = (
    (("count_reset", lambda s, t: s.v),), ())


def _observer(xp):
  """(init, update): sums of the masked reward nest and discount, and the
  count of frames that end an episode, per row. A masked frame is a
  boundary (LAST to MID), so it ends none."""

  def init(kind):
    zeros = {"scalar": xp.zeros((B,)), "vector": xp.zeros((B, 3)),
             "dict": {"b": xp.zeros((B, 2)), "a": xp.zeros((B,))}}[kind]
    return (zeros, xp.zeros((B,)), xp.zeros((B,), dtype=xp.int32))

  def update(state, frame):
    rewards, discounts, lasts = state
    add = (jax.tree_util.tree_map if xp is jnp else nest_utils.tree_map)
    is_last = (frame.next_step_type == int(jts.StepType.LAST))
    return (add(lambda s, r: s + r, rewards, frame.reward),
            discounts + frame.discount,
            lasts + is_last.astype(jnp.int32) if xp is jnp
            else lasts + is_last.to(torch.int32))

  return init, update


@pytest.mark.parametrize("kind", ["scalar", "vector", "dict"])
def test_masked_frames_match_jax(kind):
  jenv = BatchedJaxEnv(JaxCountingEnv(kind), batch_size=B)
  tenv = BatchedTorchEnv(CountingEnv(kind), B, device="cpu")
  jinit, jupdate = _observer(jnp)
  tinit, tupdate = _observer(torch)
  jpolicy = JaxFixedPolicy(np.int32(0), jenv.time_step_spec(),
                           jenv.action_spec())
  tpolicy = FixedPolicy(np.int32(0), tenv.time_step_spec(),
                        tenv.action_spec())
  jdriver = JaxEpisodeDriver(jenv, jpolicy, observers=[jupdate])
  tdriver = TorchEpisodeDriver(tenv, tpolicy, observers=[tupdate])
  k_init, k_run = jax.random.split(jax.random.key(kind == "dict"))
  _, (jobs,), jsteps, jepisodes = jax.jit(
      lambda k1, k2: jdriver.run((), jdriver.init(k1), (jinit(kind),), k2,
                                 NUM_EPISODES, MAX_STEPS))(k_init, k_run)
  draws = ReplayDraws(merge_draws(
      jax_env_reset_draws(k_init, B, jenv.env),
      jax_eval_draws(k_run, B, TorchEpisodeDriver.CHECK_EVERY, jenv.env)))
  _, (tobs,), tsteps, tepisodes = tdriver.run(
      (), tdriver.init(draws), (tinit(kind),), draws, NUM_EPISODES, MAX_STEPS)
  assert tepisodes == int(jepisodes) == NUM_EPISODES
  # Row 0's second episode starts with the auto-reset's boundary step.
  assert int(jsteps) == 2 * EPISODE + 1 <= tsteps
  pairs = ([(tobs[0][k], jobs[0][k]) for k in tobs[0]] if kind == "dict"
           else [(tobs[0], jobs[0])])
  for t, j in pairs:
    assert tuple(t.shape) == tuple(j.shape)
    assert_close(t, j, err_msg=kind)
  assert_close(tobs[1], jobs[1])
  assert_equal(tobs[2], jobs[2])
  assert_equal(tobs[2], [2, 1, 1])
  # Rows 1 and 2 ended one episode, row 0 two: their reward sums are those
  # of one and two unmasked episodes.
  first = nest_utils.flatten(tobs[0])[0]
  assert bool((first[1:] != 0).all())
