"""Data parallelism: the port's 2-rank gloo runs against the JAX package's
runs on a 2-device mesh (`tests/test_parallel.py`'s paths).

The three paths of `__graft_entry__.py:dryrun_multichip` (the fused DQN
loop, sharded PPO, sharded PER) run in two spawned processes joined by
gloo through a `file://` rendezvous in `tmp_path`
(`torch_dryrun.spawn_ranks`, every rank joined within
a timeout). Each rank replays the draws of its JAX shard: the global init
draws (the state is built for the global batch, then cut), its rows of
every collect draw, its shard's sample draws (``fold_in(key, shard)``)
and its shard's PPO permutations (``split(epoch_key, n_sh)[shard]``).

After a few iterations, on every rank: the reported losses, the networks,
the Adam moments (the second moments to atol 1e-9: squared gradients),
PPO's normalizers, the metric deques and counters match the JAX run at
rtol 1e-5 / atol 1e-6; each rank's replay rows and priorities equal its
shard of the JAX storage (floats at the same tolerance); replicated
tensors are bit-equal across ranks; and the bytes each iteration passes
to `torch.distributed` stay under the parameter and optimizer bytes plus
the per-row metric traffic: the gradient's all-reduce, a few scalars and
the metric rows' all-gathers, nothing replay- or rollout-sized.

The fourth path, LinUCB's sufficient statistics summed over the data axis
(`_dryrun_bandit_psum`, `test_parallel.py::test_bandit_psum_axis`), runs
`torch_dryrun.run_bandit` on two gloo ranks against one process over the
whole batch and the JAX agent's `shard_map` train over a 2-device mesh.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.agents.ppo import PPOClipAgent as JaxPPOClipAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.parallel import create_mesh as jax_create_mesh
from agents_tpu.parallel import shard_loop_state as jax_shard_loop_state
from agents_tpu.replay_buffers import PrioritizedReplay as JaxPER
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.train import OnPolicyTrainLoop as JaxOnPolicyTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch import specs
from agents_tpu_torch.parallel import Mesh, shard_loop_state
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws
from test_torch_parity_utils import (jax_collect_draws, jax_env_reset_draws,
                                     jax_reset_draws, jax_sample_draws,
                                     merge_draws)
import torch_dryrun as dryrun

RTOL, ATOL, NU_ATOL = 1e-5, 1e-6, 1e-9
RANKS = 2
TIMEOUT_S = 240
# The fused loops: B rows, ring CAP, sample S, episodes cut to LIMIT steps.
B, CAP, S, FC, LIMIT, INITIAL, ITERS, BUF = 8, 32, 16, (16, 8), 12, 8, 4, 5
# PPO: B rows, T steps, (16,) nets, shards = ranks.
PB, PT, PFC, EPOCHS, MBS, PLIMIT, PITERS = 4, 9, (16,), 2, 2, 8, 3


# -- the JAX runs --------------------------------------------------------------

def _jax_fused(mesh, prioritized):
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=LIMIT), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = jnetworks.make_q_network(tss.observation, asp, fc_layer_params=FC)
  agent = JaxDqnAgent(tss, asp, qnet, optax.adam(1e-3),
                      td_errors_loss_fn=jcommon.element_wise_squared_loss,
                      **dryrun.DQN_HP)
  spec = jtj.trajectory_spec(tss, asp)
  replay = (JaxPER(spec, B, CAP, alpha=dryrun.PER_ALPHA) if prioritized
            else JaxUniformReplay(spec, B, CAP))
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(BUF),
                           sample_batch_size=S, per_beta=dryrun.PER_BETA,
                           mesh=mesh)


def _rows(records, rank, rows):
  """A rank's rows of every [B, ...] draw."""
  return {site: [np.asarray(v)[rank * rows:(rank + 1) * rows] for v in vs]
          for site, vs in records.items()}


def _fused_draws(key, asp, prioritized):
  """(global init draws, each rank's iteration draws) of the JAX loop's
  `init(key, INITIAL)` and ITERS iterations over the 2-device mesh."""
  _, k_driver, k_collect, k = jax.random.split(key, 4)
  init = merge_draws({"env_reset": [jax_reset_draws(k_driver, B)]},
                     jax_collect_draws(k_collect, INITIAL, B, asp))
  per_rank = [[] for _ in range(RANKS)]
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    collect = jax_collect_draws(k_c, 1, B, asp)
    k_train = jax.random.split(k_s, 1)[0]
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    for r in range(RANKS):
      shard_key = jax.random.fold_in(k_train, r)
      per_rank[r].append(_rows(collect, r, B // RANKS))
      per_rank[r].append(
          {"per_u": [np.asarray(jax.random.uniform(shard_key,
                                                   (S // RANKS,)))]}
          if prioritized else
          jax_sample_draws(shard_key, S // RANKS, num_valid, B // RANKS))
  return init, [merge_draws(*recs) for recs in per_rank]


def _run_jax_fused(prioritized, key):
  mesh = jax_create_mesh(RANKS)
  loop = _jax_fused(mesh, prioritized)
  state0 = jax.jit(lambda k: loop.init(k, initial_collect_steps=INITIAL))(key)
  q0 = jax.device_get(state0.agent_state.q_params)
  state = jax_shard_loop_state(state0, mesh, B, replay_capacity=CAP)
  step = jax.jit(loop.iteration)
  losses = []
  for _ in range(ITERS):
    state, info = step(state)
    losses.append(float(info.loss))
  init, ranks = _fused_draws(key, loop.env.action_spec(), prioritized)
  return loop, state, losses, q0, init, ranks


def _jax_ppo(mesh=None):
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=PLIMIT), batch_size=PB)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = JaxPPOClipAgent(
      tss, asp, optax.adam(3e-4),
      jnetworks.make_actor_distribution_network(tss.observation, asp,
                                                fc_layer_params=PFC),
      jnetworks.make_value_network(tss.observation, fc_layer_params=PFC),
      num_epochs=EPOCHS, num_minibatches=MBS, num_minibatch_shards=RANKS,
      entropy_regularization=0.01)
  return JaxOnPolicyTrainLoop(env, agent, jmetrics.standard_collect_metrics(
      BUF), rollout_length=PT)


def _run_jax_ppo(key):
  mesh = jax_create_mesh(RANKS)
  loop = _jax_ppo()
  state0 = jax.jit(loop.init)(key)
  params0 = jax.device_get(state0.agent_state)

  def place(x):
    if hasattr(x, "shape") and len(x.shape) >= 1 and x.shape[0] == PB:
      return jax.device_put(x, NamedSharding(mesh, P("data")))
    return jax.device_put(x, NamedSharding(mesh, P()))

  state = jax.tree_util.tree_map(place, state0)
  step = jax.jit(loop.iteration)
  losses = []
  for _ in range(PITERS):
    state, info = step(state)
    losses.append(float(info.loss))
  # Draws: init (global), then per iteration each rank's rows of the
  # rollout's draws and its shard's permutation of each epoch.
  env, asp = loop.env.env, loop.env.action_spec()
  _, k_driver, k = jax.random.split(key, 3)
  init = jax_env_reset_draws(k_driver, PB, env)
  per = PB // RANKS * (PT - 1)
  per_rank = [[] for _ in range(RANKS)]
  for _ in range(PITERS):
    k, k_collect, k_train = jax.random.split(k, 3)
    collect = jax_collect_draws(k_collect, PT, PB, asp, env, "ppo")
    perms = [[np.asarray(jax.random.permutation(sk, per))
              for sk in jax.random.split(ek, RANKS)]
             for ek in jax.random.split(k_train, EPOCHS)]
    for r in range(RANKS):
      per_rank[r].append(_rows(collect, r, PB // RANKS))
      per_rank[r].append({"ppo_permutation": [p[r] for p in perms]})
  return (loop, state, losses, params0, init,
          [merge_draws(*recs) for recs in per_rank])


# -- the port's ranks ----------------------------------------------------------

def _build_fused(prioritized, q_state_dict):
  return functools.partial(
      dryrun.build_fused_loop, device="cpu", batch_size=B, capacity=CAP,
      sample_batch_size=S, fc=FC, max_episode_steps=LIMIT,
      metrics_buffer=BUF, prioritized=prioritized, q_state_dict=q_state_dict)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  jax_runs = {"dqn": _run_jax_fused(False, jax.random.key(7)),
              "per": _run_jax_fused(True, jax.random.key(8)),
              "ppo": _run_jax_ppo(jax.random.key(9))}
  jobs = []
  for name in ("dqn", "per"):
    _, _, _, q0, init, ranks = jax_runs[name]
    jobs.append((_build_fused(name == "per",
                              convert.q_params_to_state_dict(q0)),
                 init, ranks, ITERS, INITIAL))
  _, _, _, p0, init, ranks = jax_runs["ppo"]
  jobs.append((functools.partial(
      dryrun.build_ppo_loop, device="cpu", batch_size=PB,
      rollout_length=PT, num_epochs=EPOCHS, num_minibatches=MBS,
      num_minibatch_shards=RANKS, fc=PFC, max_episode_steps=PLIMIT,
      metrics_buffer=BUF,
      actor_state_dict=convert.actor_params_to_state_dict(p0.actor_params),
      value_state_dict=convert.value_params_to_state_dict(p0.value_params)),
               init, ranks, PITERS, 0))
  workdir = str(tmp_path_factory.mktemp("dp"))
  results = dryrun.spawn_ranks(dryrun.run_jobs, RANKS, (jobs,), workdir,
                               backend="gloo", device="cpu",
                               timeout_s=TIMEOUT_S)
  # results[rank][job]
  return {name: (jax_runs[name], [results[r][j] for r in range(RANKS)])
          for j, name in enumerate(("dqn", "per", "ppo"))}


def _close(actual, expected, msg, atol=ATOL):
  np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                             rtol=RTOL, atol=atol, err_msg=msg)


def _check_metrics(snap, jstate, msg):
  """The replicated deques and counters against the JAX metric states."""
  host = jax.device_get(jstate.metric_states)
  steps, episodes, ret, length = host
  assert int(snap["metrics.0"]) == int(steps), msg
  assert int(snap["metrics.1"]) == int(episodes), msg
  for i, st in ((2, ret), (3, length)):
    data = snap[f"metrics.{i}.deque.buffer"][:-1]
    _close(data, st.deque.data, f"{msg} deque {i}")
    assert int(snap[f"metrics.{i}.deque.count"]) == int(st.deque.count)
  assert int(episodes) > 0, "no episode ended: the deques were not fed"


def _check_common(ranks, jlosses, msg):
  for r, res in enumerate(ranks):
    _close(res["losses"], jlosses, f"{msg} rank {r} losses")
  _, differ = dryrun.merge_snapshots([r["snapshot"] for r in ranks])
  assert differ == [], f"{msg}: replicated tensors differ across ranks"


@pytest.mark.parametrize("name", ["dqn", "per"])
def test_fused_loop_over_two_ranks_matches_the_jax_mesh(runs, name):
  (jloop, jstate, jlosses, _, _, _), ranks = runs[name]
  _check_common(ranks, jlosses, name)
  host = jax.device_get(jstate.agent_state)
  adam = host.opt_state[0]
  expect = {}
  for field, tree in (("q_network", host.q_params),
                      ("target_q_network", host.target_q_params)):
    for k, v in convert.q_params_to_state_dict(tree).items():
      expect[f"agent.{field}.{k}"] = v
  mus = list(convert.q_params_to_state_dict(adam.mu).values())
  nus = list(convert.q_params_to_state_dict(adam.nu).values())
  storage = jax.device_get(jstate.replay_state.storage)
  for r, res in enumerate(ranks):
    snap = res["snapshot"]
    for k, v in expect.items():
      _close(snap[k], v, f"{name} rank {r} {k}")
    for i, (mu, nu) in enumerate(zip(mus, nus)):
      _close(snap[f"agent.optimizer.{i}.exp_avg"], mu, f"mu {i}")
      _close(snap[f"agent.optimizer.{i}.exp_avg_sq"], nu, f"nu {i}",
             NU_ATOL)
      assert float(snap[f"agent.optimizer.{i}.step"]) == float(adam.count)
    _check_metrics(snap, jstate, f"{name} rank {r}")
    rows = slice(r * B // RANKS, (r + 1) * B // RANKS)
    for f in ("step_type", "observation", "action", "next_step_type",
              "reward", "discount"):
      _close(snap[f"replay.storage.{f}"], getattr(storage, f)[:, rows],
             f"{name} rank {r} replay {f}")
    if name == "per":
      _close(snap["replay.priorities"],
             np.asarray(jstate.replay_state.priorities)[:, rows],
             f"rank {r} priorities")
      _close(snap["replay.max_priority"], jstate.replay_state.max_priority,
             f"rank {r} max priority")


def test_sharded_ppo_over_two_ranks_matches_the_jax_mesh(runs):
  (jloop, jstate, jlosses, _, _, _), ranks = runs["ppo"]
  _check_common(ranks, jlosses, "ppo")
  expect = convert.ppo_agent_state_to_torch(
      jax.device_get(jstate.agent_state))
  for r, res in enumerate(ranks):
    snap = res["snapshot"]
    for field in ("actor_network", "value_network"):
      for k, v in expect[field].items():
        _close(snap[f"agent.{field}.{k}"], v, f"rank {r} {field}.{k}")
    for i, st in expect["adam"].items():
      _close(snap[f"agent.optimizer.{i}.exp_avg"], st["exp_avg"], f"mu {i}")
      _close(snap[f"agent.optimizer.{i}.exp_avg_sq"], st["exp_avg_sq"],
             f"nu {i}", NU_ATOL)
    for field in ("obs_norm_state", "reward_norm_state"):
      for name in ("count", "mean_sum", "var_sum"):
        _close(snap[f"agent.{field}.{name}"],
               getattr(expect[field], name), f"{field}.{name}")
    _check_metrics(snap, jstate, f"ppo rank {r}")


def _param_bytes(snapshot, prefixes):
  return sum(v.numel() * v.element_size() for k, v in snapshot.items()
             if k.startswith(prefixes))


@pytest.mark.parametrize("name", ["dqn", "per", "ppo"])
def test_collective_bytes_bounded_and_no_storage_crosses(runs, name):
  """Per iteration, at most: the gradient's bytes per optimizer step (one
  for DQN and PER, EPOCHS x MBS for PPO), plus the optimizer state's
  bytes (room for the scalars: the loss, counters, PPO's denominators),
  plus the metric traffic (per collect step, 8 bytes per row for each of
  the two deque metrics and 8 for each of the two counters). Only the
  gradient's all-reduce and the metric rows' all-gathers run; nothing
  replay- or rollout-sized."""
  _, ranks = runs[name]
  snap = ranks[0]["snapshot"]
  if name == "ppo":
    nets = ("agent.actor_network.", "agent.value_network.")
    steps, rows, grad_steps = PT, PB // RANKS, EPOCHS * MBS
  else:
    nets = ("agent.q_network.",)
    steps, rows, grad_steps = 1, B // RANKS, 1
  params = _param_bytes(snap, nets)
  optimizer = _param_bytes(snap, ("agent.optimizer.",))
  metric_rows = steps * (rows * 8 * 2 + 2 * 8)
  for res in ranks:
    for used in res["bytes_per_iteration"]:
      assert 0 < used <= grad_steps * params + optimizer + metric_rows, (
          used, params)
    # The storage-size bound at a size where it binds is
    # test_torch_weak_scaling.py's.
    assert set(res["largest_numel"]) == {"all_reduce", "all_gather"}
    assert res["largest_numel"]["all_gather"] <= rows * 2
    assert res["largest_numel"]["all_reduce"] == params // 4


# -- n ranks against one process over the global batch --------------------------

@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
  """The three paths over two ranks drawing from seeded generators (each
  rank its own), recorded; then one process over the global batch
  replaying the ranks' draws (`dryrun.merge_records`), PER through
  `ShardedPrioritizedReference`. The check `chip_smoke.py`'s
  `data_parallel` phase makes on the card."""
  fused = functools.partial(
      dryrun.build_fused_loop, device="cpu", batch_size=B, capacity=CAP,
      sample_batch_size=S, fc=FC, max_episode_steps=LIMIT,
      metrics_buffer=BUF)
  ppo = functools.partial(
      dryrun.build_ppo_loop, device="cpu", batch_size=PB, rollout_length=PT,
      num_epochs=EPOCHS, num_minibatches=MBS, num_minibatch_shards=RANKS,
      fc=PFC, max_episode_steps=PLIMIT, metrics_buffer=BUF)
  cases = {
      "dqn": (fused, fused, B, ITERS, INITIAL),
      "per": (functools.partial(fused, prioritized=True),
              functools.partial(fused, reference_shards=RANKS), B, ITERS,
              INITIAL),
      "ppo": (ppo, ppo, PB, PITERS, 0)}
  jobs = [(build, 3, [100, 100], iters, steps, True)
          for build, _, _, iters, steps in cases.values()]
  workdir = str(tmp_path_factory.mktemp("dp_seeded"))
  results = dryrun.spawn_ranks(dryrun.run_jobs, RANKS, (jobs,), workdir,
                               backend="gloo", device="cpu",
                               timeout_s=TIMEOUT_S)
  out = {}
  for j, (name, (_, reference, rows, iters, steps)) in enumerate(
      cases.items()):
    ranks = [results[r][j] for r in range(RANKS)]
    records = dryrun.merge_records([r["records"] for r in ranks],
                                   rows // RANKS)
    one = dryrun.run_rank(None, reference, ranks[0]["init_records"],
                          dryrun.concat_records(records), iters, steps)
    starts = [dryrun.merge_snapshots([r["snapshots"][i] for r in ranks])[0]
              for i in range(iters + 1)]
    stepped = dryrun.step_from(reference, ranks[0]["init_records"],
                               starts[:-1], records, steps)
    out[name] = ranks, one, starts, stepped
  return out


@pytest.mark.parametrize("name", ["dqn", "per", "ppo"])
def test_two_ranks_equal_one_process_over_the_global_batch(seeded, name):
  ranks, one, _, _ = seeded[name]
  merged, differ = dryrun.merge_snapshots([r["snapshot"] for r in ranks])
  assert differ == []
  assert set(merged) == set(one["snapshot"])
  for r in ranks:
    _close(r["losses"], one["losses"], f"{name} losses")
  for key, want in one["snapshot"].items():
    got = merged[key]
    if want.is_floating_point():
      atol = NU_ATOL if key.endswith("exp_avg_sq") else ATOL
      _close(got, want, f"{name} {key}", atol)
    else:
      assert torch.equal(got, want), f"{name} {key}"


@pytest.mark.parametrize("name", ["dqn", "per", "ppo"])
def test_each_iteration_held_from_the_ranks_state(seeded, name):
  """`dryrun.step_from`: one process started before each iteration from
  the ranks' merged state (restored in place) ends it where the ranks
  do, the check `chip_smoke.py` makes for PPO on the card."""
  ranks, _, starts, stepped = seeded[name]
  assert len(stepped) == len(starts) - 1 == len(ranks[0]["losses"])
  for i, (loss, snap) in enumerate(stepped):
    _close(loss, ranks[0]["losses"][i], f"{name} loss {i}")
    for key, want in snap.items():
      got = starts[i + 1][key]
      if want.is_floating_point():
        atol = NU_ATOL if key.endswith("exp_avg_sq") else ATOL
        _close(got, want, f"{name} iteration {i} {key}", atol)
      else:
        assert torch.equal(got, want), f"{name} iteration {i} {key}"


@pytest.mark.parametrize("path", ["fused", "ppo"])
def test_restore_loads_every_tensor_of_a_snapshot(path):
  """`dryrun.restore` puts a snapshot back into a live loop state: after
  one iteration (so the optimizer holds state), every entry of a snapshot
  shifted by one reads back shifted."""
  if path == "fused":
    loop = dryrun.build_fused_loop(device="cpu", batch_size=4, capacity=8,
                                   sample_batch_size=4, fc=(8,))
    state = loop.init(seed=0, initial_collect_steps=3)
  else:
    loop = dryrun.build_ppo_loop(device="cpu", batch_size=2,
                                 rollout_length=3, num_epochs=1,
                                 num_minibatches=1, num_minibatch_shards=1,
                                 fc=(8,))
    state = loop.init(seed=0)
  state, _ = loop.iteration(state)
  shifted = {k: v + 1 for k, v in dryrun.snapshot(state).items()}
  dryrun.restore(state, shifted)
  after = dryrun.snapshot(state)
  assert set(after) == set(shifted)
  for key, want in shifted.items():
    assert torch.equal(after[key], want), key


def test_reversed_minibatch_items_change_float_order_alone():
  """`build_ppo_loop(reverse_minibatch_items=True)`, the witness of
  `dryrun.ppo_witness`: the same draws give the same minibatches in
  reverse item order, so one iteration ends within the tolerance of the
  plain loop (`dryrun.divergence` under 1) with the same metrics and
  rollout, but not bit-equal: only the float order moved."""
  snaps = []
  for reverse in (False, True):
    loop = dryrun.build_ppo_loop(device="cpu", batch_size=8,
                                 rollout_length=9, num_epochs=2,
                                 num_minibatches=2, num_minibatch_shards=2,
                                 fc=(16, 16), reverse_minibatch_items=reverse)
    state, _ = loop.iteration(loop.init(draws=Draws(3, "cpu")))
    snaps.append(dryrun.snapshot(state))
  plain, reversed_ = snaps
  (worst,) = dryrun.divergence([reversed_], [plain])
  assert 0 < worst["over_tolerance"] < 1, worst
  for key, want in plain.items():
    if not key.startswith("agent."):
      assert torch.equal(reversed_[key], want), key
  assert any(not torch.equal(reversed_[k], v) for k, v in plain.items())


def test_linear_in_row_blocks_computes_each_block_and_restores():
  """`dryrun.linear_in_row_blocks(n)`: within it a linear layer's rows
  are the rows of n separate products (bit-equal to each block computed
  alone), the same values as one product to rounding; after it,
  `torch.nn.functional.linear` is itself again."""
  linear = torch.nn.functional.linear
  g = torch.Generator().manual_seed(0)
  x, w, b = (torch.randn(shape, generator=g)
             for shape in ((10, 7), (5, 7), (5,)))
  with dryrun.linear_in_row_blocks(2):
    got = torch.nn.functional.linear(x, w, b)
  assert torch.nn.functional.linear is linear
  assert torch.equal(got, torch.cat([linear(x[:5], w, b),
                                     linear(x[5:], w, b)]))
  _close(got, linear(x, w, b), "row blocks")


def test_surrogate_trace_finds_items_changing_sides_of_the_clip():
  """`dryrun.surrogate_trace`: two ranks' [ratio, advantage, mask] traces
  against one process's, two minibatches per iteration. An item whose
  ratio crosses 1 + c with a positive advantage changes sides (its
  gradient is clipped in one run only); a masked one, or one whose
  advantage makes the clip not bind, does not."""
  def trace(ratios, advs, mask):
    return torch.tensor([ratios, advs, mask])

  one = [trace([1.0, 1.0, 0.5, 1.0], [1.0, 1.0, 1.0, 1.0], [1, 1, 1, 1]),
         trace([1.19, 1.21, 1.3, 0.79], [1.0, 1.0, 1.0, 1.0], [1, 0, 1, 1]),
         trace([1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0], [1, 1, 1, 1])]
  ranks = [[t[:, :2].clone() for t in one], [t[:, 2:].clone() for t in one]]
  ranks[0][1][0, :2] = torch.tensor([1.21, 1.19])   # item 0 crosses 1.2
  ranks[1][1][0, 1] = 0.81   # A > 0 below 1 - c: the clip never binds
  ranks[1][2][0, 0] = 1.0 + 2e-5   # 2.0027e-5 from 1 in float32
  out = dryrun.surrogate_trace(ranks, one, 0.2, per_iteration=2)
  assert out[0]["items_changing_sides"] == [(1, 1)]
  assert out[0]["first_minibatch_over_1e-5"] == 1
  assert out[0]["largest_ratio_diff"] == pytest.approx(0.02, abs=1e-6)
  assert out[1] == {"largest_ratio_diff": pytest.approx(2e-5, abs=2e-7),
                    "first_minibatch_over_1e-5": 0,
                    "items_changing_sides": []}


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_loop_state_keys_on_fields_when_dims_collide(rank):
  """Replay capacity == batch size == the Q network's first width (8): the
  storage is still cut on its row axis (axis 1), the per-row driver and
  accumulator leaves on axis 0, and the network, the deques and PER's max
  priority stay whole (the comment at JAX `mesh_utils.py:67-75`). Placement
  alone makes no collective, so each rank's cut runs here."""
  loop = dryrun.build_fused_loop(device="cpu", batch_size=8, capacity=8,
                                 sample_batch_size=8, fc=(8,),
                                 prioritized=True)
  state = loop.init(seed=0, initial_collect_steps=3)
  whole = dryrun.snapshot(state)
  assert whole["agent.q_network.encoder.layers.0.weight"].shape[0] == 8
  mesh = Mesh(2, rank, "cpu")
  cut = dryrun.snapshot(shard_loop_state(state, mesh, 8, replay_capacity=8,
                                         draws=Draws(0, "cpu")))
  rows = slice(4 * rank, 4 * rank + 4)
  for key, value in whole.items():
    if dryrun.is_replicated(key):
      assert torch.equal(cut[key], value), key
    elif key.startswith("replay."):
      assert torch.equal(cut[key], value[:, rows]), key
    else:
      assert torch.equal(cut[key], value[rows]), key
  assert cut["replay.storage.observation"].shape == (8, 4, 4)
  assert cut["metrics.2.accumulator"].shape == (4,)
  with pytest.raises(ValueError, match="draw source"):
    shard_loop_state(state, mesh, 8, replay_capacity=8)


def test_sample_sharded_matches_uniform_semantics():
  """`tests/test_parallel.py`'s case on four ranks' shards (uniform
  sampling makes no collective, so each rank's call runs here): payload
  integrity, exactly S/4 samples from each rank's rows, every row and
  time id covered, probabilities 1 / (valid * B)."""
  b, cap, s, ranks = 8, 16, 512, 4
  spec = {"obs": specs.ArraySpec((3,), np.float32),
          "tag": specs.ArraySpec((), np.int32)}
  rb = UniformReplay(spec, batch_size=b, max_length=cap, device="cpu")
  state = rb.init()
  for t in range(10):
    state = rb.add_batch(state, {
        "obs": torch.stack([torch.full((3,), 100.0 * r + t)
                            for r in range(b)]),
        "tag": torch.arange(b, dtype=torch.int32) * 100 + t})
  rows, ids, tags, obs, probs = [], [], [], [], []
  for r in range(ranks):
    local = dataclasses.replace(state, storage={
        k: v[:, r * b // ranks:(r + 1) * b // ranks]
        for k, v in state.storage.items()})
    batch, info = rb.sample_sharded(local, Draws(3 + r, "cpu"), s,
                                    Mesh(ranks, r, "cpu"))
    assert info.rows.shape == (s // ranks,)
    assert set(info.rows.tolist()) <= set(range(r * 2, r * 2 + 2))
    rows.append(info.rows)
    ids.append(info.ids)
    tags.append(batch["tag"])
    obs.append(batch["obs"])
    probs.append(info.probabilities)
  rows, ids = torch.cat(rows).numpy(), torch.cat(ids).numpy()
  np.testing.assert_array_equal(torch.cat(tags).numpy(), rows * 100 + ids)
  np.testing.assert_array_equal(torch.cat(obs)[:, 0].numpy(),
                                (rows * 100 + ids).astype(np.float32))
  assert set(rows) == set(range(b)) and set(ids) == set(range(10))
  np.testing.assert_allclose(torch.cat(probs).numpy(), 1.0 / (10 * b),
                             rtol=1e-6)
  assert math.isclose(float(torch.cat(probs).sum()) * 10 * b / s, 1.0,
                      rel_tol=1e-6)


def test_bandit_psum_axis(tmp_path):
  """(twin of test_parallel.py::test_bandit_psum_axis) LinUCB on two gloo
  ranks, each training on its half of every batch, sums its statistics
  over the ranks: A, b and n equal one process over the whole batch and
  the JAX agent (``axis_name="data"``) under `shard_map` on a 2-device
  mesh (float32 sums, rtol 1e-5 / atol 1e-6), bit-equal across the
  ranks; each train call passes exactly one all-reduce of (K·d² + K·d +
  K) float32 to `torch.distributed`."""
  from functools import partial

  from jax.experimental.shard_map import shard_map

  from agents_tpu import specs as jspecs
  from agents_tpu.bandits.agents import LinUcbAgent as JaxLinUcbAgent
  from agents_tpu.trajectories import time_step as jts

  d, k = dryrun.BANDIT_PSUM["context_dim"], dryrun.BANDIT_PSUM["num_actions"]
  batches = dryrun.bandit_batches(0, 8, 3, d, k)
  ranks = dryrun.spawn_ranks(dryrun.run_bandit, RANKS, (batches, d, k),
                             str(tmp_path), backend="gloo", device="cpu",
                             timeout_s=TIMEOUT_S)
  one = dryrun.run_bandit(None, batches, d, k, device="cpu")

  agent = JaxLinUcbAgent(jts.time_step_spec(jspecs.ArraySpec((d,),
                                                             np.float32)),
                         jspecs.BoundedArraySpec((), np.int32, 0, k - 1),
                         axis_name="data")
  mesh = jax_create_mesh(RANKS)
  state = agent.init(jax.random.key(0))
  for obs, action, reward in batches:
    traj = jtj.Trajectory(
        step_type=np.zeros((8,), np.int32), observation=obs, action=action,
        policy_info=(), next_step_type=np.full((8,), 2, np.int32),
        reward=reward, discount=np.ones((8,), np.float32))
    dp_train = shard_map(
        lambda st, tr: agent.train(st, tr)[0], mesh=mesh,
        in_specs=(P(), jax.tree_util.tree_map(lambda _: P("data"), traj)),
        out_specs=P(), check_rep=False)
    state = jax.jit(dp_train)(state, traj)

  per_call = dryrun.bandit_statistics_bytes(d, k)
  for r in ranks:
    for name in ("a_mat", "b_vec", "num_samples"):
      assert torch.equal(r[name], ranks[0][name]), name
      np.testing.assert_allclose(r[name].numpy(), one[name].numpy(),
                                 rtol=1e-5, atol=1e-6, err_msg=name)
      np.testing.assert_allclose(r[name].numpy(),
                                 np.asarray(getattr(state, name)),
                                 rtol=1e-5, atol=1e-6, err_msg=name)
    assert r["train_step"] == one["train_step"] == len(batches)
    assert r["bytes_per_call"] == [per_call] * len(batches)
    assert r["calls_per_call"] == [1] * len(batches)
    assert r["largest_numel"] == {"all_reduce": per_call // 4}
  assert float(one["num_samples"].sum()) == 8 * len(batches)
