"""Port parity: the collect metrics (`agents_tpu_torch.metrics.torch_metrics`)
against the JAX package's `jax_metrics`, frame by frame.

Counts are compared exactly; float results with rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.metrics import jax_metrics
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.metrics import torch_metrics
from agents_tpu_torch.trajectories import trajectory as ttj
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)


def test_deque_push_batch_overflow_keeps_most_recent():
  dq = torch_metrics.DequeState.create(4)
  dq = dq.push_batch(torch.ones(10, dtype=torch.bool), torch.arange(10.0))
  assert sorted(dq.data.tolist()) == [6.0, 7.0, 8.0, 9.0]
  assert int(dq.count) == 10
  jdq = jax_metrics.DequeState.create(4).push_batch(
      jnp.ones(10, bool), jnp.arange(10.0))
  assert_equal(dq.data, jdq.data)


def test_deque_drop_slot_holds_zeros():
  """Rows a push drops land in the spare slot as zeros, whatever their
  values: the slot is the same whichever write the card keeps."""
  state = torch_metrics.DequeState.create(2)
  mask = torch.tensor([True, False, True, True, False])
  state = state.push_batch(mask, torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]))
  assert_equal(state.buffer, np.array([4.0, 3.0, 0.0], np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deque_push_batch_matches_jax(seed):
  """Random masks over several pushes, partial and overflowing."""
  rng = np.random.RandomState(seed)
  dq, jdq = (torch_metrics.DequeState.create(5),
             jax_metrics.DequeState.create(5))
  for _ in range(6):
    n = rng.randint(1, 12)
    mask = rng.rand(n) < 0.6
    values = rng.randn(n).astype(np.float32)
    dq = dq.push_batch(torch.from_numpy(mask), torch.from_numpy(values))
    jdq = jdq.push_batch(jnp.asarray(mask), jnp.asarray(values))
    assert_equal(dq.data, jdq.data)
    assert int(dq.count) == int(jdq.count)
    for stat in ("mean", "max", "min"):
      assert_close(getattr(dq, stat)(), getattr(jdq, stat)(), err_msg=stat)
  empty = torch_metrics.DequeState.create(3)
  assert float(empty.mean()) == float(empty.max()) == float(empty.min()) == 0


def _frames(t, b, seed):
  """Random legal step-type streams: FIRST -> MID* -> LAST -> FIRST."""
  rng = np.random.RandomState(seed)
  st = np.zeros((t + 1, b), np.int32)
  for i in range(1, t + 1):
    prev = st[i - 1]
    st[i] = np.where(prev == 2, 0, np.where(rng.rand(b) < 0.25, 2, 1))
  reward = rng.randn(t, b).astype(np.float32)
  return [dict(step_type=st[i], observation=np.zeros((b, 4), np.float32),
               action=np.zeros(b, np.int32), next_step_type=st[i + 1],
               reward=reward[i], discount=np.ones(b, np.float32))
          for i in range(t)]


def test_standard_collect_metrics_match_jax():
  b = 6
  jm = jax_metrics.standard_collect_metrics(5)
  tm = torch_metrics.standard_collect_metrics(5)
  js = [m.init(b) for m in jm]
  tsts = [m.init(b) for m in tm]
  update = jax.jit(lambda states, f: [m.update(s, f)
                                      for m, s in zip(jm, states)])
  for i, f in enumerate(_frames(60, b, 0)):
    jf = jtj.Trajectory(policy_info=(), **{k: jnp.asarray(v)
                                           for k, v in f.items()})
    tf = ttj.Trajectory(policy_info=(), **{k: torch.from_numpy(v)
                                           for k, v in f.items()})
    js = update(js, jf)
    tsts = [m.update(s, tf) for m, s in zip(tm, tsts)]
    for jmet, tmet, jst, tst in zip(jm, tm, js, tsts):
      assert jmet.name == tmet.name
      assert_close(tmet.result(tst), jmet.result(jst),
                   err_msg=f"{tmet.name} frame {i}")
  episodes = int(tm[1].result(tsts[1]))
  assert episodes > 5 * 2  # the 5-slot deques wrapped


def test_metrics_on_the_reference_frames():
  """The hand-made stream of tests/test_metric_equality.py: 2 rows, 8
  frames, boundary frames carry no reward."""
  st = np.array([[0, 1, 1, 2, 0, 1, 1, 2], [0, 1, 2, 0, 1, 2, 0, 1]]).T
  nst = np.array([[1, 1, 2, 0, 1, 1, 2, 0], [1, 2, 0, 1, 2, 0, 1, 2]]).T
  reward = np.where(st == 2, 0.0, 1.0).astype(np.float32)
  tm = torch_metrics.standard_collect_metrics(10)
  states = [m.init(2) for m in tm]
  for t in range(8):
    f = ttj.Trajectory(
        step_type=torch.from_numpy(st[t].astype(np.int32)),
        observation=torch.zeros(2), action=torch.zeros(2, dtype=torch.int32),
        policy_info=(), next_step_type=torch.from_numpy(nst[t].astype(
            np.int32)), reward=torch.from_numpy(reward[t]),
        discount=torch.ones(2))
    states = [m.update(s, f) for m, s in zip(tm, states)]
  results = {m.name: float(m.result(s)) for m, s in zip(tm, states)}
  # Row 0 plays two 3-step episodes, row 1 three 2-step ones.
  np.testing.assert_allclose(
      [results[k] for k in ("EnvironmentSteps", "NumberOfEpisodes",
                            "AverageReturn", "AverageEpisodeLength")],
      [12.0, 5.0, 2.4, 2.4], rtol=1e-6)
