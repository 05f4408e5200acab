"""Port parity: specs, time steps and trajectory conversions
(`agents_tpu_torch.specs`, `.trajectories`) against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import policy_step as tps
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)


def _trajectory(rng, b, t, module, array):
  discount = rng.choice([0.0, 1.0, 0.5], size=(b, t)).astype(np.float32)
  return module.Trajectory(
      step_type=array(rng.randint(0, 3, (b, t)).astype(np.int32)),
      observation=array(rng.randn(b, t, 4).astype(np.float32)),
      action=array(rng.randint(0, 2, (b, t)).astype(np.int32)),
      policy_info=(),
      next_step_type=array(rng.randint(0, 3, (b, t)).astype(np.int32)),
      reward=array(rng.randn(b, t).astype(np.float32)),
      discount=array(discount))


@pytest.mark.parametrize("n", [1, 3])
def test_to_n_step_transition_matches_jax(n):
  """reward = sum gamma^k prod d r_k; discount = gamma^(N-1) prod d; the
  first frame's reward/discount are NaN-filled."""
  rng = np.random.RandomState(n)
  jt = _trajectory(np.random.RandomState(n), 5, n + 1, jtj, jnp.asarray)
  tt = _trajectory(rng, 5, n + 1, ttj, torch.from_numpy)
  jtr = jtj.to_n_step_transition(jt, gamma=0.9)
  ttr = ttj.to_n_step_transition(tt, gamma=0.9)
  assert_close(ttr.next_time_step.reward, jtr.next_time_step.reward)
  assert_close(ttr.next_time_step.discount, jtr.next_time_step.discount)
  assert_equal(ttr.next_time_step.step_type, jtr.next_time_step.step_type)
  assert_equal(ttr.time_step.step_type, jtr.time_step.step_type)
  assert_close(ttr.time_step.observation, jtr.time_step.observation)
  assert_close(ttr.next_time_step.observation,
               jtr.next_time_step.observation)
  assert_equal(ttr.action_step.action, jtr.action_step.action)
  assert torch.isnan(ttr.time_step.reward).all()
  assert torch.isnan(ttr.time_step.discount).all()
  if n == 3:
    # Closed form for one row: gamma^(N-1) * prod d.
    d = tt.discount[0, :-1]
    assert_close(ttr.next_time_step.discount[0], 0.81 * torch.prod(d))


@pytest.mark.parametrize("t", [2, 4])
def test_to_transition_matches_jax(t):
  """T-1 adjacent transitions; the first time step's reward and discount
  are zero-filled; the next observation is the following frame's."""
  jt = _trajectory(np.random.RandomState(t), 5, t, jtj, jnp.asarray)
  tt = _trajectory(np.random.RandomState(t), 5, t, ttj, torch.from_numpy)
  jtr, ttr = jtj.to_transition(jt), ttj.to_transition(tt)
  for part in ("time_step", "next_time_step"):
    for field in ("step_type", "reward", "discount", "observation"):
      assert_equal(getattr(getattr(ttr, part), field),
                   getattr(getattr(jtr, part), field), f"{part}.{field}")
  assert_equal(ttr.action_step.action, jtr.action_step.action)
  assert tuple(ttr.time_step.step_type.shape) == (5, t - 1)
  assert not ttr.time_step.reward.any()


def test_check_adjacent_transition_sequence_reads_the_shape_only():
  tt = _trajectory(np.random.RandomState(0), 3, 2, ttj, torch.from_numpy)
  ttj.check_adjacent_transition_sequence(tt, "SacAgent")
  for bad in (_trajectory(np.random.RandomState(0), 3, 3, ttj,
                          torch.from_numpy),
              tt.replace(step_type=tt.step_type[:, 0])):
    with pytest.raises(ValueError, match="SacAgent"):
      ttj.check_adjacent_transition_sequence(bad, "SacAgent")
    with pytest.raises(ValueError):
      jtj.check_adjacent_transition_sequence(
          jtj.Trajectory(**{k: (jnp.asarray(v.numpy()) if isinstance(
              v, torch.Tensor) else v) for k, v in vars(bad).items()}),
          "SacAgent")


def test_to_n_step_transition_rejects_short_or_unbatched():
  tt = _trajectory(np.random.RandomState(0), 2, 1, ttj, torch.from_numpy)
  with pytest.raises(ValueError):
    ttj.to_n_step_transition(tt, 0.9)
  with pytest.raises(ValueError):
    ttj.to_n_step_transition(tt.replace(discount=tt.discount[:, 0]), 0.9)


def test_from_transition_and_trajectory_spec_match_jax():
  obs = np.arange(8, dtype=np.float32).reshape(2, 4)
  jt0 = jts.restart(jnp.asarray(obs), batch_size=2)
  tt0 = tts.restart(torch.from_numpy(obs), batch_size=2)
  for field in ("step_type", "reward", "discount"):
    assert_equal(getattr(tt0, field), getattr(jt0, field))
  nxt = dict(step_type=np.array([1, 2], np.int32),
             reward=np.array([1.0, 2.0], np.float32),
             discount=np.array([1.0, 0.0], np.float32), observation=obs + 1)
  jframe = jtj.from_transition(
      jt0, jps.PolicyStep(action=jnp.asarray([0, 1])),
      jts.TimeStep(**{k: jnp.asarray(v) for k, v in nxt.items()}))
  tframe = ttj.from_transition(
      tt0, tps.PolicyStep(action=torch.tensor([0, 1])),
      tts.TimeStep(**{k: torch.from_numpy(v) for k, v in nxt.items()}))
  for field in ("step_type", "observation", "action", "next_step_type",
                "reward", "discount"):
    assert_equal(getattr(tframe, field), getattr(jframe, field))
  assert_equal(tframe.is_last(), jframe.is_last())
  assert_equal(tframe.is_boundary(), jframe.is_boundary())

  obs_spec = jspec.BoundedArraySpec((4,), np.float32, -1.0, 1.0)
  jspec_nest = jtj.trajectory_spec(
      jts.time_step_spec(obs_spec),
      jspec.BoundedArraySpec((), np.int32, 0, 1))
  tspec_nest = ttj.trajectory_spec(
      tts.time_step_spec(tspec.BoundedArraySpec((4,), np.float32, -1.0, 1.0)),
      tspec.BoundedArraySpec((), np.int32, 0, 1))
  for field in ("step_type", "observation", "action", "reward", "discount"):
    j, t = getattr(jspec_nest, field), getattr(tspec_nest, field)
    assert (j.shape, j.dtype) == (t.shape, t.dtype), field


def test_zero_spec_nest_and_spec_checks():
  spec = {"a": tspec.ArraySpec((2,), np.float32),
          "b": tspec.BoundedArraySpec((), np.int32, 0, 4)}
  zeros = tspec.zero_spec_nest(spec, outer_dims=(3,), device="cpu")
  assert zeros["a"].shape == (3, 2) and zeros["a"].dtype == torch.float32
  assert zeros["b"].shape == (3,) and zeros["b"].dtype == torch.int32
  assert spec["a"].check_array(torch.zeros(2))
  assert not spec["a"].check_array(torch.zeros(3))
  assert spec["b"].check_array(torch.tensor(4, dtype=torch.int32))
  assert not spec["b"].check_array(torch.tensor(5, dtype=torch.int32))
  assert spec["b"].num_values == 5
  with pytest.raises(ValueError):
    tspec.BoundedArraySpec((), np.float32, 1.0, 0.0)


def test_sample_spec_nest_bounded_int_is_inclusive():
  spec = tspec.BoundedArraySpec((), np.int32, 0, 1)
  out = tspec.sample_spec_nest(spec, Draws(0, "cpu"), outer_dims=(4096,))
  assert out.dtype == torch.int32
  values = set(out.unique().tolist())
  assert values == {0, 1}
  # Float bounds: uniform inside them.
  fspec = tspec.BoundedArraySpec((3,), np.float32, -2.0, 5.0)
  f = tspec.sample_spec_nest(fspec, Draws(1, "cpu"), outer_dims=(512,))
  assert f.shape == (512, 3) and f.dtype == torch.float32
  assert float(f.min()) >= -2.0 and float(f.max()) <= 5.0
  # The draws come from the named site.
  replay = ReplayDraws({"random_action": [np.array([1, 0, 1])]})
  assert_equal(tspec.sample_spec(spec, replay, (3,), site="random_action"),
               [1, 0, 1])
