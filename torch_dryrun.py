"""Data-parallel dry runs over `torch.distributed`.

A check harness beside `chip_smoke.py`, outside the package (the JAX
package's dry run lives in `__graft_entry__.py` the same way): the CPU
tests and the script's `data_parallel` phase import it. The port's twins of the first three paths of the JAX package's multi-chip
dry run (``__graft_entry__.py:dryrun_multichip``): the fused DQN loop with
its replay sharded on the env rows, sharded PPO (shard-local minibatches)
and sharded PER (shard-local inverse-CDF sampling); and the twin of its
fourth, LinUCB's sufficient statistics summed over the data axis
(`_dryrun_bandit_psum`: `run_bandit`). `spawn_ranks` runs a
function in n processes joined in one process group; `run_rank` builds a
loop, shards its state over the mesh and runs a few iterations with
injected or recorded draws, returning a snapshot of every tensor and the
bytes each iteration passed to `torch.distributed`.

A run over n ranks equals one process over the global batch given the
same draws: `merge_records` turns the ranks' recorded draws into that
process's stream, `merge_snapshots` the ranks' snapshots into its state
(and lists replicated tensors that differ across ranks), and a PER
reference samples its rows as n equal-mass shards
(`ShardedPrioritizedReference`), the semantics of `sample_sharded`.
`step_from` holds each iteration on its own: it starts the one process
from the ranks' merged state before the iteration.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import multiprocessing
import os
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from agents_tpu_torch.parallel import distributed
from agents_tpu_torch.parallel.mesh_utils import create_mesh, shard_loop_state
from agents_tpu_torch.replay_buffers.prioritized_replay import (
    PrioritizedReplay)
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

DQN_HP = dict(epsilon_greedy=0.1, gamma=0.99, target_update_tau=0.05,
              target_update_period=5)
PER_ALPHA, PER_BETA = 0.6, 0.4
# Draw sites that a sharded run draws once per shard per call, in shard
# order (a PER sample's stratified uniforms, a PPO epoch's permutations);
# every other site draws this rank's rows (or samples) at once.
PER_SHARD_SITES = ("per_u", "ppo_permutation")


# -- the loops -----------------------------------------------------------------

class ShardedPrioritizedReference(PrioritizedReplay):
  """One process's `PrioritizedReplay` that samples its B rows as
  `num_shards` equal blocks, each by inverse CDF over its own priority
  mass with its own [S/n] uniforms (in block order), probabilities
  divided by n and IS weights normalized by the global max: what
  `sample_sharded` computes over n ranks, as a plain reference."""

  def __init__(self, *args, num_shards: int, **kwargs):
    super().__init__(*args, **kwargs)
    self.num_shards = num_shards

  def sample(self, state, draws, sample_batch_size, num_steps=None,
             beta=0.4):
    n, local = self.num_shards, self.local(self.num_shards)
    b = self.batch_size // n
    parts = []
    for i in range(n):
      cut = lambda x: x[:, i * b:(i + 1) * b]  # noqa: E731
      shard = dataclasses.replace(
          state, storage=nest_utils.tree_map(cut, state.storage),
          priorities=cut(state.priorities))
      batch, info = local._sample(shard, draws, sample_batch_size // n,
                                  num_steps, beta)
      parts.append((batch, info._replace(rows=info.rows + i * b)))
    batch = nest_utils.tree_map(lambda *xs: torch.cat(xs),
                                *[p[0] for p in parts])
    info = type(parts[0][1])(*(torch.cat(xs) for xs in zip(
        *[p[1] for p in parts])))
    return batch, info._replace(
        probabilities=info.probabilities / n,
        is_weights=info.is_weights / torch.clamp_min(info.is_weights.max(),
                                                     1e-30))


def build_fused_loop(mesh=None, *, device="cuda", batch_size: int,
                     capacity: int,
                     sample_batch_size: int, fc: Sequence[int],
                     max_episode_steps: Optional[int] = None,
                     metrics_buffer: int = 20, prioritized: bool = False,
                     reference_shards: int = 0, q_state_dict=None):
  """The fused DQN loop on CartPole at the bench point's settings
  (`DQN_HP`, Adam, squared TD loss; `bench.py:398-420` at B=4096, ring
  512, sample 256, (100, 50)), optionally over PER (alpha 0.6, beta 0.4;
  `reference_shards` > 0: the one-process reference of an n-rank run),
  over `mesh` when given. `q_state_dict` (numpy or tensors) replaces the
  seeded initial Q-network."""
  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import common

  cartpole = (CartPole() if max_episode_steps is None
              else CartPole(max_episode_steps=max_episode_steps))
  env = BatchedTorchEnv(cartpole, batch_size, device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device).manual_seed(0)
  qnet = make_q_network(tss.observation, asp, fc_layer_params=tuple(fc),
                        device=device, generator=generator)
  if q_state_dict is not None:
    qnet.load_state_dict({k: torch.as_tensor(v)
                          for k, v in q_state_dict.items()})
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   device=device, **DQN_HP)
  spec = tj.trajectory_spec(tss, asp)
  if reference_shards:
    replay = ShardedPrioritizedReference(
        spec, batch_size, capacity, alpha=PER_ALPHA, device=device,
        num_shards=reference_shards)
  elif prioritized:
    replay = PrioritizedReplay(spec, batch_size, capacity, alpha=PER_ALPHA,
                               device=device)
  else:
    replay = UniformReplay(spec, batch_size, capacity, device=device)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(
                            metrics_buffer),
                        sample_batch_size=sample_batch_size,
                        per_beta=PER_BETA, mesh=mesh, device=device)


def build_ppo_loop(mesh=None, *, device="cuda", batch_size: int,
                   rollout_length: int, num_epochs: int,
                   num_minibatches: int, num_minibatch_shards: int,
                   fc: Sequence[int], max_episode_steps: int = 200,
                   metrics_buffer: Optional[int] = 20,
                   actor_state_dict=None, value_state_dict=None,
                   reverse_minibatch_items: bool = False,
                   record_surrogate: bool = False):
  """PPO-clip on CartPole at `examples/ppo_cartpole.py`'s settings (B=32,
  T=128, 10 epochs x 8 minibatches, (64, 64), Adam 3e-4, entropy 0.01)
  with `num_minibatch_shards`, over `mesh` when given; no metrics when
  `metrics_buffer` is None.

  With `reverse_minibatch_items` each minibatch takes its items in
  reverse order: the same update up to the order its sums add in (a
  witness of `ppo_witness`). With `record_surrogate` the agent appends
  each minibatch's ``[3, items]`` importance ratios, advantages and mask
  (on the host; one more actor forward, outside the gradient) to its
  `surrogate_trace`, which `run_rank` returns."""
  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.ppo import PPOClipAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.networks import (make_actor_distribution_network,
                                         make_value_network)
  from agents_tpu_torch.train import OnPolicyTrainLoop

  env = BatchedTorchEnv(CartPole(max_episode_steps=max_episode_steps),
                        batch_size, device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device).manual_seed(0)
  actor = make_actor_distribution_network(
      tss.observation, asp, fc_layer_params=tuple(fc), device=device,
      generator=generator)
  value = make_value_network(tss.observation, fc_layer_params=tuple(fc),
                             device=device, generator=generator)
  for net, sd in ((actor, actor_state_dict), (value, value_state_dict)):
    if sd is not None:
      net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
  agent = PPOClipAgent(
      tss, asp, lambda p: torch.optim.Adam(p, lr=3e-4), actor, value,
      num_epochs=num_epochs, num_minibatches=num_minibatches,
      num_minibatch_shards=num_minibatch_shards,
      entropy_regularization=0.01, device=device)
  if record_surrogate:
    _record_surrogate(agent)
  if reverse_minibatch_items:
    index_fn = agent._minibatch_index_fn
    agent._minibatch_index_fn = lambda n, b: (
        lambda draws: [idx.flip(0) for idx in index_fn(n, b)(draws)])
  return OnPolicyTrainLoop(
      env, agent, metrics=(() if metrics_buffer is None else
                           metrics.standard_collect_metrics(metrics_buffer)),
      rollout_length=rollout_length, mesh=mesh, device=device)


def _record_surrogate(agent):
  from agents_tpu_torch.utils import common

  loss, agent.surrogate_trace = agent._loss, []

  def recording(agent_state, batch):
    out = loss(agent_state, batch)
    obs, step_type, actions, *_, advantages, old_log_prob, mask = batch
    with torch.no_grad():
      dist, _ = agent_state.actor_network(
          agent._normalized(agent_state, obs), step_type, ())
      ratio = torch.exp(common.log_probability(dist, actions) - old_log_prob)
      agent.surrogate_trace.append(
          torch.stack([ratio, advantages, mask]).cpu())
    return out

  agent._loss = recording


def surrogate_trace(rank_traces: Sequence[list], reference: list,
                    clipping: float, per_iteration: int):
  """Per iteration, where a run's clipped surrogate leaves a reference's:
  the largest |ratio difference| over its minibatches, the first
  minibatch at which it passes 1e-5, and the (minibatch, count) of items
  whose gradient the clip passes in one run and not in the other (mask
  on, and not A > 0 with ratio > 1 + c or A < 0 with ratio < 1 - c). The
  ranks' items of a minibatch are their shards' in rank order, the one
  process's order."""

  def passed(x):
    ratio, adv, mask = x
    return (mask > 0) & ~(((adv > 0) & (ratio > 1 + clipping))
                          | ((adv < 0) & (ratio < 1 - clipping)))

  out = []
  for c, want in enumerate(reference):
    if c % per_iteration == 0:
      out.append({"largest_ratio_diff": 0.0, "first_minibatch_over_1e-5":
                  None, "items_changing_sides": []})
    got = torch.cat([r[c] for r in rank_traces], dim=1)
    diff = float((got[0] - want[0]).abs().max())
    it = out[-1]
    it["largest_ratio_diff"] = max(it["largest_ratio_diff"], diff)
    if diff > 1e-5 and it["first_minibatch_over_1e-5"] is None:
      it["first_minibatch_over_1e-5"] = c % per_iteration
    sides = int((passed(got) != passed(want)).sum())
    if sides:
      it["items_changing_sides"].append((c % per_iteration, sides))
  return out


@contextlib.contextmanager
def linear_in_row_blocks(blocks: int):
  """Within it, every `torch.nn.functional.linear` computes its rows
  (leading dim) in `blocks` blocks, as `blocks` ranks each compute
  theirs: the same values up to the GEMMs' shapes."""
  linear = torch.nn.functional.linear

  def blocked(x, weight, bias=None):
    return torch.cat([linear(part, weight, bias) for part in x.chunk(blocks)])

  torch.nn.functional.linear = blocked
  try:
    yield
  finally:
    torch.nn.functional.linear = linear


# -- one rank's run --------------------------------------------------------------

def _source(draws, device, seed_offset: int = 0):
  """Records -> a replaying source; an int seed -> a recording source
  over ``Draws(seed + seed_offset)``."""
  if isinstance(draws, int):
    return RecordingDraws(Draws(draws + seed_offset, device))
  return ReplayDraws(draws, device)


def _tensors(prefix, nest, out):
  """Every tensor of a nest of dataclasses, tuples, lists and dicts, by
  path (networks and optimizers are left to their own state)."""
  if isinstance(nest, torch.Tensor):
    out[prefix] = nest
  elif dataclasses.is_dataclass(nest) and not isinstance(nest, type):
    for f in dataclasses.fields(nest):
      _tensors(f"{prefix}.{f.name}", getattr(nest, f.name), out)
  elif isinstance(nest, (tuple, list)):
    for i, x in enumerate(nest):
      _tensors(f"{prefix}.{i}", x, out)
  elif isinstance(nest, dict):
    for k, x in nest.items():
      _tensors(f"{prefix}.{k}", x, out)
  return out


def _state_tensors(state) -> Dict[str, torch.Tensor]:
  """The live tensors of a loop state outside its networks and
  optimizers: the agent state's own, the driver, metric and replay
  states'."""
  out = _tensors("agent", state.agent_state, {})
  _tensors("driver", state.driver_state, out)
  _tensors("metrics", state.metric_states, out)
  return _tensors("replay", getattr(state, "replay_state", None), out)


def _modules_and_optimizers(state):
  """(field name, network or optimizer) of the agent state."""
  agent = state.agent_state
  return [(f.name, getattr(agent, f.name)) for f in dataclasses.fields(agent)
          if isinstance(getattr(agent, f.name),
                        (torch.nn.Module, torch.optim.Optimizer))]


def _optimizer_params(optimizer):
  return [p for g in optimizer.param_groups for p in g["params"]]


def snapshot(state) -> Dict[str, torch.Tensor]:
  """Every tensor of a loop state on the CPU, by path: the agent's
  networks (``agent.<field>.<param>``), optimizer state
  (``agent.<field>.<i>.<name>``) and tensors; the driver, replay and
  metric states (``driver.``, ``replay.``, ``metrics.``)."""
  out = {}
  for name, value in _modules_and_optimizers(state):
    if isinstance(value, torch.nn.Module):
      for k, t in value.state_dict().items():
        out[f"agent.{name}.{k}"] = t.detach().cpu().clone()
    else:
      for i, p in enumerate(_optimizer_params(value)):
        for k, t in value.state.get(p, {}).items():
          out[f"agent.{name}.{i}.{k}"] = torch.as_tensor(t).cpu().clone()
  out.update({k: t.detach().cpu().clone()
              for k, t in _state_tensors(state).items()})
  return out


def is_replicated(key: str) -> bool:
  """Whether a snapshot entry is replicated over the ranks (the agent
  state, the metric deques and counters, PER's max priority)."""
  return (key.startswith("agent.") or key == "replay.max_priority"
          or (key.startswith("metrics.") and ".accumulator" not in key))


def restore(state, snap: Dict[str, torch.Tensor]) -> None:
  """Copy a `snapshot` back into `state`, in place (shapes must agree):
  networks, optimizer state, and every tensor the snapshot names."""
  for name, value in _modules_and_optimizers(state):
    prefix = f"agent.{name}."
    if isinstance(value, torch.nn.Module):
      value.load_state_dict({k[len(prefix):]: v for k, v in snap.items()
                             if k.startswith(prefix)})
      continue
    for i, p in enumerate(_optimizer_params(value)):
      entries = {k[len(f"{prefix}{i}."):]: v for k, v in snap.items()
                 if k.startswith(f"{prefix}{i}.")}
      if entries:   # copies: the optimizer updates its state in place
        value.state[p] = {k: v.clone() if k == "step"   # on the host
                          else v.to(p.device, copy=True)
                          for k, v in entries.items()}
  for key, tensor in _state_tensors(state).items():
    if key in snap:
      tensor.copy_(snap[key])


def _build_and_init(build, mesh, init_draws, initial_collect_steps):
  loop = build(mesh)
  init_source = _source(init_draws, loop.device)
  kwargs = ({"initial_collect_steps": initial_collect_steps}
            if hasattr(loop, "initial_collect") else {})
  return loop, init_source, loop.init(draws=init_source, **kwargs)


def run_rank(mesh, build: Callable, init_draws, draws, iterations: int,
             initial_collect_steps: int = 0,
             every_iteration: bool = False) -> Dict:
  """Build ``build(mesh)``'s loop, init it for the global batch from
  `init_draws`, shard the state over `mesh` (None: the one-process
  reference) with this rank's `draws`, and run `iterations` iterations.

  `init_draws` and `draws` are records to replay or int seeds to draw
  and record from (the rank's seed offset by its rank). Returns the
  losses, the bytes and collectives each iteration passed to
  `torch.distributed`, the largest tensor per collective kind, the
  state's `snapshot` (with `every_iteration`, also before and after each
  iteration, "snapshots"), and the recorded draws ("init_records", and
  "records": one dict per iteration)."""
  loop, init_source, state = _build_and_init(build, mesh, init_draws,
                                             initial_collect_steps)
  rank = 0 if mesh is None else mesh.rank
  source = _source(draws, loop.device, seed_offset=1 + rank)
  replay = getattr(loop, "replay", None)
  if mesh is not None:
    state = shard_loop_state(state, mesh, loop.env.batch_size,
                             replay.capacity if replay else None,
                             draws=source)
  out = {"losses": [], "bytes_per_iteration": [], "calls_per_iteration": [],
         "largest_numel": {}, "records": [],
         "snapshots": [snapshot(state)] if every_iteration else []}
  for _ in range(iterations):
    recording = isinstance(source, RecordingDraws)
    if recording:   # this iteration's draws on their own
      source = RecordingDraws(source.source)
    state = dataclasses.replace(state, draws=source)
    if mesh is not None:
      mesh.reset_bytes()
    state, info = loop.iteration(state)
    out["losses"].append(float(info.loss))
    if every_iteration:
      out["snapshots"].append(snapshot(state))
    if recording:
      out["records"].append(dict(source.records))
    if mesh is not None:
      out["bytes_per_iteration"].append(mesh.bytes_passed)
      out["calls_per_iteration"].append(mesh.calls)
      for kind, numel in mesh.largest_numel.items():
        out["largest_numel"][kind] = max(out["largest_numel"].get(kind, 0),
                                         numel)
  out["snapshot"] = snapshot(state)
  if hasattr(loop.agent, "surrogate_trace"):
    out["surrogate"] = loop.agent.surrogate_trace
  if isinstance(init_source, RecordingDraws):
    out["init_records"] = dict(init_source.records)
  return out


def step_from(build: Callable, init_draws, snapshots: Sequence[Dict],
              records: Sequence[Dict], initial_collect_steps: int = 0):
  """One process over the global batch that starts each iteration i from
  ``snapshots[i]`` (an n-rank run's merged state before it) with the
  draws ``records[i]``: each iteration held on its own, as the card
  phases hold a train step from the CPU's state. Returns (loss, the
  state's `snapshot`) after each iteration."""
  loop, _, state = _build_and_init(build, None, init_draws,
                                   initial_collect_steps)
  out = []
  for snap, recs in zip(snapshots, records):
    restore(state, snap)
    state = dataclasses.replace(state, draws=ReplayDraws(recs, loop.device))
    state, info = loop.iteration(state)
    out.append((float(info.loss), snapshot(state)))
  return out


def run_jobs(mesh, jobs: Sequence[tuple]):
  """`run_rank` of each job ``(build, init_draws, draws_by_rank, *rest)``
  (rest: `run_rank`'s further arguments), this rank taking
  ``draws_by_rank[mesh.rank]``; one spawn of ranks runs several paths."""
  return [run_rank(mesh, build, init_draws, draws_by_rank[mesh.rank], *rest)
          for build, init_draws, draws_by_rank, *rest in jobs]


def merge_records(rank_records: Sequence[Sequence[Dict]],
                  local_rows: int) -> list:
  """The one-process draw stream of an n-rank run, iteration by
  iteration (`rank_records[r]`: rank r's per-iteration records): per call,
  the ranks' draws of each site concatenated in rank order
  (``replay_rows`` offset by ``rank * local_rows``, the rank's first
  global row), except the `PER_SHARD_SITES`, whose draws interleave rank
  by rank."""
  merged = []
  for per_iteration in zip(*rank_records):
    out = {}
    for site in per_iteration[0]:
      per_rank = [list(r[site]) for r in per_iteration]
      if site in PER_SHARD_SITES:
        out[site] = [per_rank[r][c] for c in range(len(per_rank[0]))
                     for r in range(len(per_rank))]
        continue
      out[site] = []
      for parts in zip(*per_rank):
        if site == "replay_rows":
          parts = [p + r * local_rows for r, p in enumerate(parts)]
        out[site].append(
            torch.cat([torch.as_tensor(p) for p in parts]).numpy())
    merged.append(out)
  return merged


def concat_records(records: Sequence[Dict]) -> Dict:
  """Per-iteration draw records joined into one stream, site by site."""
  out = {}
  for rec in records:
    for site, values in rec.items():
      out.setdefault(site, []).extend(values)
  return out


def merge_snapshots(snapshots: Sequence[Dict]):
  """(the one-process state of an n-rank run, the replicated entries that
  differ across ranks). Replicated entries are rank 0's; per-row entries
  are the ranks' in rank order, on axis 1 for replay storage and
  priorities (``[capacity, B, ...]``), else on axis 0."""
  merged, differ = {}, []
  for key, value in snapshots[0].items():
    if is_replicated(key):
      merged[key] = value
      if any(not torch.equal(value, s[key]) for s in snapshots[1:]):
        differ.append(key)
    else:
      axis = 1 if key.startswith("replay.") else 0
      merged[key] = torch.cat([s[key] for s in snapshots], dim=axis)
  return merged, differ


def divergence(states: Sequence[Dict], references: Sequence[Dict]):
  """Per pair of snapshots, the float tensor that leaves the reference
  most against the tolerance 1e-5 + 1e-4 max|ref|: its name, largest |d|
  and that over the tolerance."""
  out = []
  for got, want in zip(states, references):
    worst = max(((float((got[k] - v).abs().max()),
                  1e-5 + 1e-4 * float(v.abs().max()), k)
                 for k, v in want.items()
                 if v.is_floating_point() and v.numel()),
                key=lambda t: t[0] / t[1])
    out.append({"tensor": worst[2], "abs": worst[0],
                "over_tolerance": worst[0] / worst[1]})
  return out


# -- LinUCB's statistics over the data axis --------------------------------------

# The JAX dry run's LinUCB: 2-dim contexts, 3 arms.
BANDIT_PSUM = dict(context_dim=2, num_actions=3)


def bandit_batches(seed: int, batch_size: int, num_batches: int,
                   context_dim: int, num_actions: int):
  """numpy (contexts [B, d], actions [B], rewards [B]) of `num_batches`
  train calls: normal contexts and rewards, actions cycling over the
  arms as in the JAX dry run."""
  import numpy as np
  rng = np.random.default_rng(seed)
  return [(rng.normal(size=(batch_size, context_dim)).astype(np.float32),
           (np.arange(batch_size) % num_actions).astype(np.int32),
           rng.normal(size=(batch_size,)).astype(np.float32))
          for _ in range(num_batches)]


def run_bandit(mesh, batches, context_dim: int, num_actions: int,
               device=None):
  """LinUCB trained on this rank's rows of each batch (every row without
  a mesh), its statistics summed over the mesh's ranks in one all-reduce
  per train call. Returns its final A, b, n (on the CPU) and, per train
  call, the bytes and collectives passed to `torch.distributed` and the
  largest tensor of each collective kind."""
  import numpy as np

  from agents_tpu_torch.bandits.agents import LinUcbAgent
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.trajectories import trajectory as tj

  device = mesh.device if mesh is not None else device
  agent = LinUcbAgent(
      ts.time_step_spec(array_spec.ArraySpec((context_dim,), np.float32)),
      array_spec.BoundedArraySpec((), np.int32, 0, num_actions - 1),
      device=device)
  agent.mesh = mesh
  state = agent.init()
  out = {"bytes_per_call": [], "calls_per_call": [], "largest_numel": {}}
  for obs, action, reward in batches:
    rows = slice(None)
    if mesh is not None:
      local = obs.shape[0] // mesh.size
      rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
      mesh.reset_bytes()
    to = lambda x: torch.as_tensor(x[rows], device=device)  # noqa: E731
    n = obs[rows].shape[0]
    traj = tj.Trajectory(
        step_type=torch.zeros((n,), dtype=torch.int32, device=device),
        observation=to(obs), action=to(action), policy_info=(),
        next_step_type=torch.full((n,), 2, dtype=torch.int32, device=device),
        reward=to(reward), discount=torch.ones((n,), device=device))
    state, _ = agent.train(state, traj)
    if mesh is not None:
      out["bytes_per_call"].append(mesh.bytes_passed)
      out["calls_per_call"].append(mesh.calls)
      for kind, numel in mesh.largest_numel.items():
        out["largest_numel"][kind] = max(out["largest_numel"].get(kind, 0),
                                         numel)
  out.update(a_mat=state.a_mat.cpu(), b_vec=state.b_vec.cpu(),
             num_samples=state.num_samples.cpu(),
             train_step=state.train_step)
  return out


def bandit_statistics_bytes(context_dim: int, num_actions: int) -> int:
  """The bytes of one train call's summed statistics: (K d² + K d + K)
  float32."""
  k, d = num_actions, context_dim
  return (k * d * d + k * d + k) * 4


# -- n processes -----------------------------------------------------------------

def _rank_main(fn, rank, world_size, backend, device, workdir, timeout_s,
               args):
  try:
    if torch.device(device).type == "cpu":
      torch.set_num_threads(1)
    distributed.initialize(
        num_processes=world_size, process_id=rank, backend=backend,
        init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        timeout_s=timeout_s)
    mesh = create_mesh(world_size, device=device)
    result = fn(mesh, *args)
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
  except BaseException:
    with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
      f.write(traceback.format_exc())
    raise
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple, workdir: str,
                backend: str = "gloo", device="cuda",
                timeout_s: float = 300.0):
  """Run ``fn(mesh, *args)`` in `world_size` spawned processes joined in
  one process group (rendezvous through a file in `workdir`, a new or
  empty directory); returns each rank's result, in rank order.

  Every rank is joined within `timeout_s` (the group's collectives time
  out then too); a rank still alive is killed and `TimeoutError` raised,
  so a hung rank fails its caller instead of hanging it. A rank that
  fails raises `RuntimeError` with its traceback.
  """
  workdir = os.path.abspath(workdir)   # a file:// URL takes a full path
  os.makedirs(workdir, exist_ok=True)
  ctx = multiprocessing.get_context("spawn")
  procs = [ctx.Process(target=_rank_main,
                       args=(fn, r, world_size, backend, str(device),
                             workdir, timeout_s, args), daemon=True)
           for r in range(world_size)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + timeout_s
  try:
    for p in procs:
      p.join(max(0.0, deadline - time.monotonic()))
  finally:
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
      if p.is_alive():
        p.kill()
        p.join(10)
  if hung:
    raise TimeoutError(f"ranks {hung} did not finish within {timeout_s} s")
  errors = []
  for r, p in enumerate(procs):
    err = os.path.join(workdir, f"rank{r}.err")
    if p.exitcode != 0 or os.path.exists(err):
      text = open(err).read() if os.path.exists(err) else ""
      errors.append(f"rank {r} exited with {p.exitcode}:\n{text}")
  if errors:
    raise RuntimeError("\n".join(errors))
  return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
          for r in range(world_size)]


# -- PPO's float-order witness ----------------------------------------------------

PPO_CARTPOLE = dict(batch_size=32, rollout_length=128, num_epochs=10,
                    num_minibatches=8, num_minibatch_shards=2, fc=(64, 64))


def ppo_witness(seed: int, iterations: int, workdir: str, device="cuda",
                ranks: int = 2, timeout_s: float = 600.0):
  """PPO at `PPO_CARTPOLE` over `ranks` gloo ranks against one process
  over the global batch with the ranks' draws, and against two witnesses
  that differ from that process in float order alone: every linear
  layer computed in the ranks' `ranks` row blocks ("row_blocks"), and
  each minibatch's items reversed ("reversed"). Returns, per iteration,
  the `divergence` of the ranks' merged state from the one process
  ("ranks") and from the row-block witness ("ranks_from_row_blocks"),
  of each witness from the one process, and the ranks' `surrogate_trace`
  against the one process and the row-block witness."""
  build = functools.partial(build_ppo_loop, device=device,
                            record_surrogate=True, **PPO_CARTPOLE)
  jobs = [(build, seed, [seed] * ranks, iterations, 0, True)]
  runs = [r[0] for r in spawn_ranks(run_jobs, ranks, (jobs,), workdir,
                                    backend="gloo", device=device,
                                    timeout_s=timeout_s)]
  records = concat_records(merge_records(
      [r["records"] for r in runs], PPO_CARTPOLE["batch_size"] // ranks))

  def one_process(blocks=1, **kwargs):
    with linear_in_row_blocks(blocks):
      return run_rank(None, functools.partial(build, **kwargs),
                      runs[0]["init_records"], records, iterations,
                      every_iteration=True)

  one, blocks = one_process(), one_process(blocks=ranks)
  rev = one_process(reverse_minibatch_items=True)
  merged = [merge_snapshots([r["snapshots"][i] for r in runs])[0]
            for i in range(1, iterations + 1)]
  per_iteration = (PPO_CARTPOLE["num_epochs"]
                   * PPO_CARTPOLE["num_minibatches"])
  clipping = 0.2   # PPOClipAgent's importance_ratio_clipping
  return {
      "ranks": divergence(merged, one["snapshots"][1:]),
      "ranks_from_row_blocks": divergence(merged, blocks["snapshots"][1:]),
      "row_blocks": divergence(blocks["snapshots"][1:], one["snapshots"][1:]),
      "reversed": divergence(rev["snapshots"][1:], one["snapshots"][1:]),
      "surrogate_ranks": surrogate_trace(
          [r["surrogate"] for r in runs], one["surrogate"], clipping,
          per_iteration),
      "surrogate_ranks_from_row_blocks": surrogate_trace(
          [r["surrogate"] for r in runs], blocks["surrogate"], clipping,
          per_iteration)}


def main(argv=None):
  """``python torch_dryrun.py [--device cpu] [--iterations 8] [--seeds
  11,12,13]``: `ppo_witness` per seed, one JSON line each."""
  import argparse
  import json
  import tempfile

  parser = argparse.ArgumentParser(description=main.__doc__)
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--iterations", type=int, default=8)
  parser.add_argument("--seeds", default="11,12,13")
  args = parser.parse_args(argv)
  if torch.device(args.device).type == "cpu":
    torch.set_num_threads(1)
  for seed in (int(x) for x in args.seeds.split(",")):
    with tempfile.TemporaryDirectory() as workdir:
      result = ppo_witness(seed, args.iterations, workdir, args.device)
    print(json.dumps({"seed": seed, **result}), flush=True)


if __name__ == "__main__":
  main()
