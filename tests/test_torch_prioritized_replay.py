"""`agents_tpu_torch.replay_buffers.PrioritizedReplay` and the PER branch of
the port's `FusedTrainLoop`, against the JAX package.

The twins of `tests/test_prioritized_replay.py` (all but the sharded
case, which waits for the port's data parallelism) run on the port alone
or side by side with the JAX class, with the stratified uniforms of
``jax.random.uniform(key, (S,))`` replayed at the port's "per_u" site.

Sampling is held bit for bit where the CDF is exact: with integer
priorities, alpha 1 and epsilon 0 every partial sum is an integer below
2**24, exact in float32 whatever the summation order, so ids, rows,
probabilities and the gathered frames must be equal. With random
priorities XLA's CPU cumsum and torch's sum in other orders, and pow may
differ by an ulp, so the CDF is held at rtol 1e-6 and the indices must be
equal wherever the uniform lies more than 4 ulp(total) from its
neighbouring CDF entries (the gap rule of CEM's elites and DDQN's
argmax). IS weights go through pow(., -beta) and are held at rtol 1e-6.
Everything else in float32 at rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import \
    PrioritizedBufferInfo as JaxPrioritizedBufferInfo
from agents_tpu.replay_buffers import PrioritizedReplay as JaxPrioritizedReplay
from agents_tpu.replay_buffers import prioritized_replay as jax_per
from agents_tpu.specs import array_spec as jax_array_spec
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch import metrics
from agents_tpu_torch.agents.categorical_dqn import CategoricalDqnAgent
from agents_tpu_torch.agents.dqn import DqnAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.networks import make_q_network, make_q_rnn_network
from agents_tpu_torch.replay_buffers import (PrioritizedBufferInfo,
                                             PrioritizedReplay)
from agents_tpu_torch.replay_buffers.prioritized_replay import chunked_cumsum
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.train import Checkpointer, FusedTrainLoop
from agents_tpu_torch.train.checkpointer import capture
from agents_tpu_torch.trajectories import policy_step
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, convert
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_checkpoint import assert_nests_equal
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_reset_draws,
                                     merge_draws, to_np)
from test_torch_reference_bars import port_per_loop, run_per

torch.set_num_threads(1)

CPU = dict(device="cpu")
IS_RTOL = 1e-6


def _spec(jax_side=False):
  lib = jax_array_spec if jax_side else array_spec
  return {"x": lib.ArraySpec((2,), np.float32)}


def _frame(v, b):
  return {"x": torch.full((b, 2), float(v))}


def _info(ids, rows):
  n = len(ids)
  return PrioritizedBufferInfo(
      ids=torch.tensor(ids), rows=torch.tensor(rows),
      probabilities=torch.ones(n), is_weights=torch.ones(n))


def _u(key, s):
  return np.asarray(jax.random.uniform(key, (s,)))


# -- twins of tests/test_prioritized_replay.py --------------------------------


def test_sampling_proportional_to_priority():
  rb = PrioritizedReplay(_spec(), batch_size=1, max_length=8, alpha=1.0, **CPU)
  st = rb.init()
  for i in range(4):
    st = rb.add_batch(st, _frame(i, 1), priorities=torch.ones(1))
  st = rb.update_priorities(st, _info([3], [0]), torch.tensor([5.0]))
  batch, info = rb.sample(st, Draws(0, "cpu"), 4096)
  frac_3 = float((info.ids == 3).double().mean())
  # p = (1, 1, 1, 5 + eps) / 8: item 3 takes ~5/8 of the samples.
  assert abs(frac_3 - 5.0 / 8.0) < 0.03
  assert_close(batch["x"][:, 0], info.ids.to(torch.float32))


def test_new_items_get_max_priority():
  rb = PrioritizedReplay(_spec(), batch_size=1, max_length=8, **CPU)
  st = rb.init()
  st = rb.add_batch(st, _frame(0, 1), priorities=torch.tensor([10.0]))
  st = rb.add_batch(st, _frame(1, 1))
  assert float(st.priorities[1, 0]) >= 10.0


def test_stale_update_dropped():
  rb = PrioritizedReplay(_spec(), batch_size=1, max_length=4, alpha=1.0, **CPU)
  st = rb.init()
  for i in range(8):  # ids 0..7; ids 0-3 overwritten
    st = rb.add_batch(st, _frame(i, 1), priorities=torch.ones(1))
  before = st.priorities.clone()
  st = rb.update_priorities(st, _info([1], [0]), torch.tensor([100.0]))
  assert torch.equal(st.priorities, before)
  # A live id at the same ring position is updated.
  st = rb.update_priorities(st, _info([5], [0]), torch.tensor([100.0]))
  assert float(st.priorities[1, 0]) > 99.0


def test_duplicate_updates_max_combine():
  rb = PrioritizedReplay(_spec(), batch_size=1, max_length=4, alpha=1.0,
                         epsilon=0.0, **CPU)
  st = rb.init()
  for i in range(4):
    st = rb.add_batch(st, _frame(i, 1), priorities=torch.ones(1))
  st = rb.update_priorities(st, _info([2, 2], [0, 0]),
                            torch.tensor([0.5, 3.0]))
  assert abs(float(st.priorities[2, 0]) - 3.0) < 1e-6


def test_window_validity_and_wraparound():
  rb = PrioritizedReplay(_spec(), batch_size=2, max_length=4, alpha=0.0, **CPU)
  st = rb.init()
  for i in range(6):  # count=6, size=4: valid ids 2..5
    st = rb.add_batch(st, _frame(i, 2))
  batch, info = rb.sample(st, Draws(1, "cpu"), 512, num_steps=2)
  ids = info.ids.numpy()
  assert ids.min() >= 2 and ids.max() <= 4   # start 5 has no successor
  v = batch["x"].numpy()                     # [S, 2, 2]
  np.testing.assert_allclose(v[:, 1, 0], v[:, 0, 0] + 1.0)


def test_uniform_priorities_give_unit_is_weights():
  rb = PrioritizedReplay(_spec(), batch_size=2, max_length=8, alpha=1.0, **CPU)
  st = rb.init()
  for i in range(8):
    st = rb.add_batch(st, _frame(i, 2), priorities=torch.ones(2))
  _, info = rb.sample(st, Draws(0, "cpu"), 64, beta=1.0)
  np.testing.assert_allclose(info.is_weights.numpy(), np.ones(64), rtol=1e-5)


def test_per_dqn_train_step_end_to_end():
  """PER sample -> DQN train with IS weights -> update_priorities with the
  TD errors: the loss is finite and the priorities move."""
  B = 8
  env = BatchedTorchEnv(CartPole(), B, **CPU)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=(32,), **CPU)
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   epsilon_greedy=0.1, target_update_tau=0.05,
                   target_update_period=5, gamma=0.99,
                   td_errors_loss_fn=common.element_wise_squared_loss, **CPU)
  rb = PrioritizedReplay(ttj.trajectory_spec(tss, asp), B, 64, **CPU)
  draws = Draws(0, "cpu")
  agent_state, rb_state = agent.init(), rb.init()
  env_state, step = env.reset(draws)
  for _ in range(32):
    action = draws.randint("random_action", (B,), 0, 2)
    env_state, step2 = env.step(env_state, step, action, draws)
    rb_state = rb.add_batch(rb_state, ttj.from_transition(
        step, policy_step.PolicyStep(action=action), step2))
    step = step2
  exp, info = rb.sample(rb_state, draws, 16, num_steps=2)
  agent_state, loss = agent.train(agent_state, exp, weights=info.is_weights)
  rb_state = rb.update_priorities(rb_state, info, loss.extra.td_error)
  assert torch.isfinite(loss.loss)
  assert float(rb_state.priorities.std()) > 0.0


# The JAX package's PER loop at `PER` reaches last-20 returns of 192.75,
# 200.0, 157.85, 192.0 and 117.2 over seeds 0-4 (`python
# tests/test_torch_reference_bars.py per`), so by `per_bar`'s rule the bar
# is the JAX test's own 100 (117.2 less a third of the spread is below it).
PER_BAR = 100.0


def test_fused_loop_with_prioritized_replay_learns():
  """The port's PER loop at the JAX test's config (`PER`, 1,600
  iterations) on the CPU beats the bar the JAX package's own runs set, and
  its priorities spread (the port reaches 181.9-200.0 over seeds 0-4)."""
  out = run_per(0, port=True)
  assert out["losses_finite"]
  assert out["last20_average_return"] > PER_BAR, out
  assert out["priority_std"] > 0.0


def test_sample_sharded_waits_for_data_parallelism():
  """Data parallelism has come: over a mesh of one rank (no process
  group) `sample_sharded` is `sample` on the same draws, and rows that do
  not split over the mesh raise. The 2-rank cases are in
  `test_torch_parallel.py`."""
  from agents_tpu_torch.parallel import Mesh, create_mesh

  rb = PrioritizedReplay(_spec(), batch_size=2, max_length=4, **CPU)
  state = rb.init()
  for t in range(3):
    state = rb.add_batch(state, _frame(t, 2),
                         priorities=torch.tensor([1.0 + t, 0.5]))
  _, a = rb.sample(state, Draws(5, "cpu"), 4, beta=0.5)
  _, b = rb.sample_sharded(state, Draws(5, "cpu"), 4,
                           create_mesh(device="cpu"), beta=0.5)
  for x, y in zip(a, b):
    assert torch.equal(x, y)
  odd = PrioritizedReplay(_spec(), batch_size=3, max_length=4, **CPU)
  with pytest.raises(ValueError, match="divisible"):
    odd.sample_sharded(odd.init(), Draws(0, "cpu"), 4,
                       Mesh(2, 0, "cpu"))


# -- bit for bit and under the gap rule against the JAX class ------------------


def _filled(B, CAP, frames, alpha, epsilon, rng, priorities):
  """A JAX and a port buffer given the same frames and priorities."""
  jrb = JaxPrioritizedReplay(_spec(True), B, CAP, alpha=alpha,
                             epsilon=epsilon)
  trb = PrioritizedReplay(_spec(), B, CAP, alpha=alpha, epsilon=epsilon,
                          **CPU)
  js, ts = jrb.init(), trb.init()
  for _ in range(frames):
    x = rng.randn(B, 2).astype(np.float32)
    p = priorities(rng, B)
    js = jrb.add_batch(js, {"x": jnp.asarray(x)},
                       priorities=None if p is None else jnp.asarray(p))
    ts = trb.add_batch(ts, {"x": torch.from_numpy(x)},
                       priorities=None if p is None else torch.from_numpy(p))
  return (jrb, js), (trb, ts)


def _sample_both(jside, tside, key, s, num_steps=None, beta=0.4):
  (jrb, js), (trb, ts) = jside, tside
  jb, ji = jrb.sample(js, key, s, num_steps=num_steps, beta=beta)
  tb, ti = trb.sample(ts, ReplayDraws({"per_u": [_u(key, s)]}), s,
                      num_steps=num_steps, beta=beta)
  return (jb, ji), (tb, ti)


@pytest.mark.parametrize("B,CAP,num_steps", [(4, 8, None), (64, 40, 2),
                                              (33, 100, 3)])
def test_exact_cdf_sampling_is_bit_identical(B, CAP, num_steps):
  """Integer priorities, alpha 1, epsilon 0: the chunked CDF (one chunk,
  and 2,560 and 3,300 entries over two levels) is exact, so the sample is
  equal bit for bit, windows and all; the IS weights to pow's rounding."""
  rng = np.random.RandomState(B)
  frames = CAP + 7  # wrapped: the oldest ids are gone
  jside, tside = _filled(B, CAP, frames, 1.0, 0.0, rng,
                         lambda r, b: r.randint(1, 9, b).astype(np.float32))
  assert_equal(tside[1].priorities, jside[1].priorities)
  for k in range(3):
    (jb, ji), (tb, ti) = _sample_both(jside, tside, jax.random.key(k), 256,
                                      num_steps=num_steps, beta=0.5)
    assert_equal(ti.ids, ji.ids)
    assert_equal(ti.rows, ji.rows)
    assert_equal(ti.probabilities, ji.probabilities)
    assert_close(ti.is_weights, ji.is_weights, rtol=IS_RTOL, atol=0)
    assert_equal(tb["x"], jb["x"])


def test_chunked_cumsum_keeps_two_levels():
  """`chunked_cumsum` against the JAX `_chunked_cumsum`: exact on integers
  over 1, 2 and 3 chunks, and within rtol 1e-6 on random floats."""
  rng = np.random.RandomState(0)
  for n in (700, 1024, 2049, 3000):
    ints = rng.randint(0, 9, n).astype(np.float32)
    assert_equal(chunked_cumsum(torch.from_numpy(ints)),
                 jax_per._chunked_cumsum(jnp.asarray(ints)))
    floats = rng.rand(n).astype(np.float32)
    assert_close(chunked_cumsum(torch.from_numpy(floats)),
                 jax_per._chunked_cumsum(jnp.asarray(floats)), rtol=1e-6,
                 atol=0)


def _jax_cdf(jrb, js, num_steps):
  """The JAX sample's CDF (prioritized_replay.py:167-176)."""
  n = 1 if num_steps is None else num_steps
  size = jrb.size(js)
  t_r = jrb._time_ids(js.count)
  valid = ((t_r >= 0) & (t_r >= js.count - size) & (t_r <= js.count - n))
  ps = jnp.where(valid[:, None], jnp.power(js.priorities, jrb.alpha), 0.0)
  return np.asarray(jax_per._chunked_cumsum(ps.reshape(-1)))


def _clear_of_boundaries(cdf, key, s):
  """Per sample, whether its stratified uniform lies more than 4 ulp of
  the total from the CDF entries around it (the gap rule)."""
  total = np.float32(max(cdf[-1], 1e-30))
  u = (np.arange(s, dtype=np.float32) + _u(key, s)) / np.float32(s) * total
  u = np.minimum(u, total * np.float32(1.0 - 1e-7))
  idx = np.searchsorted(cdf, u, side="right")
  lo = np.where(idx > 0, cdf[np.maximum(idx - 1, 0)], -np.inf)
  hi = cdf[np.minimum(idx, len(cdf) - 1)]
  gap = 4 * np.spacing(total)
  return (u - lo > gap) & (hi - u > gap)


@pytest.mark.parametrize("alpha", [0.6, 0.0])
def test_random_priorities_under_the_gap_rule(alpha):
  """Random priorities at alpha 0.6 (and 0, where 0**0 = 1 must be masked
  off the unwritten slots): the CDF within rtol 1e-6, the same ids and
  rows for every sample clear of a boundary, probabilities and IS weights
  within rtol 1e-6 there."""
  B, CAP, S = 48, 30, 512
  rng = np.random.RandomState(1)
  jside, tside = _filled(B, CAP, CAP - 5, alpha, 1e-6, rng,
                         lambda r, b: r.exponential(size=b).astype(
                             np.float32))
  (jrb, js), (trb, ts) = jside, tside
  tflat = torch.where(
      (torch.arange(CAP) < CAP - 5)[:, None],
      torch.pow(ts.priorities, alpha), 0.0).reshape(-1)
  jcdf = _jax_cdf(jrb, js, None)
  assert_close(chunked_cumsum(tflat), jcdf, rtol=1e-6, atol=0)
  cleared = 0
  for k in range(4):
    key = jax.random.key(10 + k)
    (jb, ji), (tb, ti) = _sample_both(jside, tside, key, S)
    clear = _clear_of_boundaries(jcdf, key, S)
    cleared += int(clear.sum())
    assert_equal(to_np(ti.ids)[clear], to_np(ji.ids)[clear])
    assert_equal(to_np(ti.rows)[clear], to_np(ji.rows)[clear])
    assert_close(to_np(ti.probabilities)[clear],
                 to_np(ji.probabilities)[clear], rtol=1e-6, atol=0)
    assert_equal(to_np(tb["x"])[clear], to_np(jb["x"])[clear])
    # Never a never-written slot.
    assert (to_np(ti.ids) >= 0).all()
  assert cleared > 0.99 * 4 * S


def test_update_priorities_bit_identical_with_duplicates_and_stale_ids():
  """Duplicate ids (max-combined), stale ids (dropped) and live ones, on
  both classes from one state: priorities and the running max equal."""
  rng = np.random.RandomState(2)
  B, CAP = 3, 5
  jside, tside = _filled(B, CAP, 9, 0.6, 1e-6, rng,
                         lambda r, b: r.rand(b).astype(np.float32))
  (jrb, js), (trb, ts) = jside, tside
  ids = np.array([4, 4, 8, 1, 6, 6, 6, 2, 5], np.int32)   # 1, 2: stale
  rows = np.array([0, 0, 2, 1, 1, 1, 1, 0, 2], np.int32)
  td = rng.randn(len(ids)).astype(np.float32) * 3
  js = jrb.update_priorities(js, JaxPrioritizedBufferInfo(
      ids=jnp.asarray(ids), rows=jnp.asarray(rows),
      probabilities=jnp.ones(len(ids)), is_weights=jnp.ones(len(ids))),
      jnp.asarray(td))
  ts = trb.update_priorities(ts, PrioritizedBufferInfo(
      ids=torch.from_numpy(ids).long(), rows=torch.from_numpy(rows).long(),
      probabilities=torch.ones(len(ids)), is_weights=torch.ones(len(ids))),
      torch.from_numpy(td))
  assert_equal(ts.priorities, js.priorities)
  assert_equal(ts.max_priority, js.max_priority)


def test_add_sequence_and_clear_match_add_batch():
  """`add_sequence` of N frames (more than the ring) equals N `add_batch`
  calls, storage, priorities and count; `clear` empties the priorities."""
  rng = np.random.RandomState(3)
  xs = rng.randn(11, 2, 2).astype(np.float32)
  a = PrioritizedReplay(_spec(), 2, 4, **CPU)
  b = PrioritizedReplay(_spec(), 2, 4, **CPU)
  sa = a.add_batch(a.init(), {"x": torch.ones(2, 2)},
                   priorities=torch.tensor([3.0, 1.0]))
  sb = b.add_batch(b.init(), {"x": torch.ones(2, 2)},
                   priorities=torch.tensor([3.0, 1.0]))
  for x in xs:
    sa = a.add_batch(sa, {"x": torch.from_numpy(x)})
  sb = b.add_sequence(sb, {"x": torch.from_numpy(xs)})
  assert sa.count == sb.count == 12
  assert_equal(sb.storage["x"], sa.storage["x"])
  assert_equal(sb.priorities, sa.priorities)
  sb = b.clear(sb)
  assert sb.count == 0 and float(sb.priorities.abs().sum()) == 0.0
  assert float(sb.max_priority) == 1.0


# -- the PER fused loop, step for step against the JAX loop --------------------

B, CAP, S, FC, LIMIT = 8, 16, 16, (16, 8), 12
INITIAL, ITERS = 8, 5
HP = dict(epsilon_greedy=0.1, gamma=0.99, target_update_tau=0.05,
          target_update_period=2)


class _JaxRecorder(JaxPrioritizedReplay):
  """Keeps each sample's info and its gap-rule mask (run eagerly)."""

  def sample(self, state, key, sample_batch_size, num_steps=None, beta=0.4,
             **kw):
    out = super().sample(state, key, sample_batch_size, num_steps, beta, **kw)
    self.infos.append(jax.device_get(out[1]))
    self.clear.append(_clear_of_boundaries(
        _jax_cdf(self, state, num_steps), key, sample_batch_size))
    self.priorities.append(np.asarray(state.priorities))
    return out


class _Recorder(PrioritizedReplay):
  """Keeps each sample's info and priorities, and the priorities each
  update starts from."""

  def sample(self, state, *args, **kwargs):
    out = super().sample(state, *args, **kwargs)
    self.infos.append(out[1])
    self.priorities.append(state.priorities.clone())
    return out

  def update_priorities(self, state, info, td_errors):
    self.before_update.append(state.priorities.clone())
    return super().update_priorities(state, info, td_errors)


def _jax_per_loop():
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=LIMIT), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = jnetworks.make_q_network(tss.observation, asp, fc_layer_params=FC)
  agent = JaxDqnAgent(tss, asp, qnet, optax.adam(1e-3),
                      td_errors_loss_fn=jcommon.element_wise_squared_loss,
                      **HP)
  replay = _JaxRecorder(jtj.trajectory_spec(tss, asp), B, CAP, alpha=0.6)
  replay.infos, replay.clear, replay.priorities = [], [], []
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(5),
                           sample_batch_size=S, per_beta=0.4)


def _torch_per_loop(q_params):
  env = BatchedTorchEnv(CartPole(max_episode_steps=LIMIT), B, **CPU)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=FC, **CPU)
  qnet.load_state_dict(convert.q_params_to_state_dict(q_params))
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   **CPU, **HP)
  replay = _Recorder(ttj.trajectory_spec(tss, asp), B, CAP, alpha=0.6, **CPU)
  replay.infos, replay.priorities, replay.before_update = [], [], []
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=S, per_beta=0.4, **CPU)


def _jax_per_loop_draws(key, asp):
  """Every draw of `init(key, INITIAL)` then ITERS iterations, per site:
  the uniform branch's draws with `replay.sample`'s ``uniform(k, (S,))``
  in place of its window starts and rows."""
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [{"env_reset": [jax_reset_draws(k_driver, B)]},
             jax_collect_draws(k_collect, INITIAL, B, asp)]
  k = k_loop
  for _ in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    records.append(jax_collect_draws(k_c, 1, B, asp))
    records.append({"per_u": [_u(jax.random.split(k_s, 1)[0], S)]})
  return merge_draws(*records)


@pytest.fixture(scope="module")
def per_runs():
  jloop = _jax_per_loop()
  key = jax.random.key(7)
  with jax.disable_jit():
    jstate = jloop.init(key, initial_collect_steps=INITIAL)
    q0 = jax.device_get(jstate.agent_state.q_params)
    jlosses = []
    for _ in range(ITERS):
      jstate, info = jloop.iteration(jstate)
      jlosses.append(np.asarray(info.loss))
  tloop = _torch_per_loop(q0)
  draws = ReplayDraws(_jax_per_loop_draws(key, jloop.env.action_spec()))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, np.stack(jlosses)), (tloop, tstate, tlosses), draws


def test_per_fused_loop_matches_jax_step_for_step(per_runs):
  (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = per_runs
  assert all(v == 0 for v in draws.remaining().values())
  jr, tr = jloop.replay, tloop.replay
  assert len(jr.infos) == len(tr.infos) == ITERS
  for i in range(ITERS):
    # Every sample clear of a CDF boundary, so its ids must be equal.
    assert jr.clear[i].all(), i
    assert_equal(tr.infos[i].ids, jr.infos[i].ids, f"ids {i}")
    assert_equal(tr.infos[i].rows, jr.infos[i].rows, f"rows {i}")
    assert_close(tr.infos[i].probabilities, jr.infos[i].probabilities,
                 err_msg=f"probabilities {i}")
    assert_close(tr.infos[i].is_weights, jr.infos[i].is_weights,
                 err_msg=f"is_weights {i}")
    # The priorities each step samples from (the previous steps' updates
    # and this iteration's insert at the running max).
    assert_close(tr.priorities[i], jr.priorities[i], err_msg=f"priorities {i}")
  assert_close(tlosses, jlosses)
  assert_close(tstate.replay_state.priorities, jstate.replay_state.priorities)
  assert_close(tstate.replay_state.max_priority,
               jstate.replay_state.max_priority)
  assert tstate.replay_state.count == int(jstate.replay_state.count)
  # TD errors differentiated the priorities.
  assert float(tstate.replay_state.priorities.std()) > 0.0
  ja = jax.device_get(jstate.agent_state)
  for tree, net in ((ja.q_params, tstate.agent_state.q_network),
                    (ja.target_q_params, tstate.agent_state.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], err_msg=k)


def _c51_per_loop():
  """The pixel example's C51 on Catch, its replay made prioritized."""
  from examples import dqn_pixels_torch

  loop = dqn_pixels_torch.build_loop(dqn_pixels_torch.Config(
      **{**dqn_pixels_torch.CATCH, "agent": "c51", "env_batch_size": 4,
         "replay_capacity": 16, "sample_batch_size": 8,
         "conv_layer_params": ((4, 3, 1),), "fc_layer_params": (16,),
         "num_atoms": 11, **CPU}))
  assert isinstance(loop.agent, CategoricalDqnAgent)
  replay = PrioritizedReplay(loop.replay.data_spec, 4, 16, **CPU)
  return FusedTrainLoop(loop.env, loop.agent, replay, metrics=loop.metrics,
                        sample_batch_size=8, **CPU)


def test_agent_without_td_error_warns_once_and_keeps_priorities():
  """C51's loss is a cross-entropy with no `td_error`: the loop warns, as
  the JAX loop does at trace time, once per loop, and the priorities keep
  their insert-time values."""
  loop = _c51_per_loop()
  state = loop.init(seed=0, initial_collect_steps=4)
  with pytest.warns(UserWarning, match="no td_error") as record:
    state, losses = loop.run(state, 3)
  assert len([w for w in record if "td_error" in str(w.message)]) == 1
  assert torch.isfinite(losses).all()
  written = (torch.arange(16) < 4 + 3).to(torch.float32)[:, None]
  assert torch.equal(state.replay_state.priorities, written.expand(16, 4))


def _rnn_per_loop():
  env = BatchedTorchEnv(CartPole(max_episode_steps=20), 4, **CPU)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_rnn_network(tss.observation, asp, input_fc_layer_params=(8,),
                            lstm_size=8, output_fc_layer_params=(8,),
                            generator=torch.Generator().manual_seed(3), **CPU)
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   gamma=0.99, train_sequence_length=4, **CPU)
  replay = _Recorder(ttj.trajectory_spec(tss, asp), 4, 32, **CPU)
  replay.infos, replay.priorities, replay.before_update = [], [], []
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=8, **CPU)


def test_sequence_loss_td_goes_back_as_its_mean_magnitude():
  """Recurrent DQN's TD errors are [S, T-1]: the loop writes back their
  mean |td| over time per item, as the JAX loop does
  (fused_loop.py:151-154). The JAX class, given that reduction of the same
  TD errors from the same priorities, writes the same priorities."""
  loop = _rnn_per_loop()
  state = loop.init(seed=1, initial_collect_steps=8)
  state, infos = loop.run_with_info(state, 2)
  td = infos.extra.td_error[-1]                            # [S, T-1]
  assert td.dim() == 2 and tuple(td.shape) == (8, 3)
  info, before = loop.replay.infos[-1], loop.replay.before_update[-1]
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=20), batch_size=4)
  jrb = JaxPrioritizedReplay(
      jtj.trajectory_spec(env.time_step_spec(), env.action_spec()), 4, 32)
  jstate = jrb.init().replace(priorities=jnp.asarray(before.numpy()),
                              count=jnp.int32(state.replay_state.count))
  jstate = jrb.update_priorities(
      jstate, JaxPrioritizedBufferInfo(
          ids=jnp.asarray(info.ids.numpy()),
          rows=jnp.asarray(info.rows.numpy()), probabilities=jnp.ones(8),
          is_weights=jnp.ones(8)),
      jnp.mean(jnp.abs(jnp.asarray(td.numpy())), axis=1))
  assert_close(state.replay_state.priorities, jstate.priorities)
  assert not torch.equal(state.replay_state.priorities, before)


def test_per_loop_resumes_bit_for_bit(tmp_path):
  """A PER loop state (priorities, max priority, the host count) through
  `Checkpointer`: N1 + N2 iterations against N1, save, a fresh loop from
  the same seed, restore and N2 more, `torch.equal` throughout."""
  n1 = n2 = 4

  def build():
    return port_per_loop(seed=2)

  loop = build()
  state = loop.init(5, initial_collect_steps=8)
  state, first = loop.run(state, n1)
  state, second = loop.run(state, n2)
  whole, final = torch.cat([first, second]), capture(state)

  loop = build()
  state = loop.init(5, initial_collect_steps=8)
  state, first = loop.run(state, n1)
  checkpointer = Checkpointer(str(tmp_path / "ck"))
  assert checkpointer.save(n1, state)
  del loop, state
  loop = build()
  restored = checkpointer.restore(loop.init(5, initial_collect_steps=8))
  restored, second = loop.run(restored, n2)
  assert torch.equal(whole, torch.cat([first, second]))
  assert_nests_equal(final, capture(restored))
  saved = capture(restored)["replay_state"]
  assert set(saved) == {"storage", "priorities", "count", "max_priority"}
  assert saved["count"] == 8 + n1 + n2
