"""Offline CQL-SAC end to end on host environments with the PyTorch port:
collect -> dataset -> offline train -> eval.

The port's twin of ``examples/cql_sac_offline.py`` (the kumar20 pipeline
over a self-generated dataset, since D4RL is absent), with the same
`Config` (plus `device`). (``examples/cql_sac_offline_torch.py`` is the
twin of the device pipeline of ``tests/test_cql_offline_e2e.py``.)

  A. A behaviour SAC ((256, 256) critic, `actor_fc_layers` actor, Adam
     3e-4) on the asynchronous collector-trainer loop over `env_batch_size`
     gymnasium envs: `behavior_env_steps` env steps at UTD
     `behavior_utd_ratio`, 32 train steps of `offline_batch_size` per
     call, 256 random ticks, a ring of 16,384 per row. In the "mixed" mix
     the collect policy's parameters are copied at `snapshot_fractions` of
     the run (checked every 64 ticks; the last one at the end).
  B. The dataset, written by `PyDriver` through `JittedPyPolicy` into
     `dataset_io.TrajectoryFileObserver` (shards of 1,024 frames of
     [B, ...]); `PyDriver`'s `max_steps` counts the non-boundary
     transitions summed over the rows. "medium": `dataset_frames` from the
     final collect policy; "mixed": `mixed_random_fraction` of them from
     `RandomPolicy`, the rest split evenly over the snapshots, each
     snapshot also scored greedily.
  C. `CqlSacAgent` over a ring sized from the dataset on disk, trained in
     calls of `train_steps_per_call` steps (the loss stays on the device
     between evals), a greedy eval over `num_eval_episodes` every
     `eval_interval` steps and at the end, the greedy policy exported
     through `PolicySaver` under ``root_dir/policies/greedy_policy``.

With `reuse_phase_ab` set to an earlier run's root_dir, phases A and B are
that run's: its dataset is copied and its comparators are read from its
``offline.jsonl``. It writes ``config.json`` and ``offline.jsonl`` under
`root_dir` (``runs/cql_sac_offline_host_torch`` unless set) and prints the
result as its last line. `train_eval(cfg, make_env=...)` takes another
host env factory (the card's smoke run uses random envs with
HalfCheetah's specs). `--smoke` runs a short, narrow config on
``Pendulum-v1``.

Usage:
  python examples/cql_sac_offline_host_torch.py [--cfg.env_name=HalfCheetah-v5]
      [--cfg.dataset_mix=mixed] [--device cuda|cpu] [--smoke]
      [--cfg.<field>=<value> ...]
"""
import copy
import dataclasses
import json
import math
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from examples.dqn_cartpole_torch import parse_args  # noqa: E402

# Phase A's settings that the JAX example fixes in code (:187-213).
BEHAVIOR_CRITIC_FC = (256, 256)
BEHAVIOR_ACTOR_LR = 3e-4
BEHAVIOR_REPLAY_LENGTH = 16384
BEHAVIOR_TRAIN_STEPS_PER_CALL = 32
BEHAVIOR_RANDOM_TICKS = 256
SNAPSHOT_EVERY_TICKS = 64
FRAMES_PER_SHARD = 1024


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "cql_sac_offline_host_torch")
  env_name: str = "HalfCheetah-v5"
  env_batch_size: int = 32
  # Phase A: a partially trained ("medium") SAC behaviour policy.
  behavior_env_steps: int = 72_000
  behavior_utd_ratio: float = 1.0
  # Phase B: frames collected from the behaviour (stochastic) policy.
  dataset_frames: int = 100_000
  # "medium": every frame from the final behaviour policy; "mixed": random
  # play plus the snapshots (the D4RL medium-replay recipe).
  dataset_mix: str = "medium"
  mixed_random_fraction: float = 0.2
  snapshot_fractions: tuple = (1 / 3, 2 / 3, 1.0)
  # An earlier run's root_dir whose dataset and comparators to reuse.
  reuse_phase_ab: str = ""
  offline_train_steps: int = 60_000
  offline_batch_size: int = 256
  cql_alpha: float = 5.0
  num_cql_samples: int = 10
  softmax_temperature: float = 1.0
  num_bc_steps: int = 20_000
  include_critic_entropy_term: bool = False
  reward_noise_variance: float = 0.0
  actor_lr: float = 3e-4
  critic_lr: float = 3e-4
  alpha_lr: float = 3e-4
  actor_fc_layers: tuple = (256, 256)
  critic_joint_fc_layers: tuple = (256, 256, 256)
  gamma: float = 0.99
  target_update_tau: float = 0.005
  reward_scale_factor: float = 0.1
  eval_interval: int = 15_000     # offline gradient steps between evals
  num_eval_episodes: int = 10
  num_eval_envs: int = 10
  train_steps_per_call: int = 64
  seed: int = 0
  device: str = "cuda"


SMOKE = dict(env_name="Pendulum-v1", env_batch_size=4,
             behavior_env_steps=1600, dataset_frames=800,
             offline_train_steps=64, offline_batch_size=64,
             num_cql_samples=2, num_bc_steps=16, actor_fc_layers=(32, 32),
             critic_joint_fc_layers=(32, 32), eval_interval=32,
             num_eval_episodes=2, num_eval_envs=2, train_steps_per_call=16)


def make_sac(cfg: Config, tss, asp, cql: bool, device, seed: int):
  """The behaviour `SacAgent` or the offline `CqlSacAgent` of `cfg` (the
  JAX example's `_make_sac`), the critic drawn before the actor from
  `seed`."""
  import torch

  from agents_tpu_torch.agents.cql import CqlSacAgent
  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_sac_actor_network)

  generator = torch.Generator(device=device)
  generator.manual_seed(seed)
  adam = lambda lr: lambda p: torch.optim.Adam(p, lr=lr)  # noqa: E731
  critic = make_critic_network(
      tss.observation, asp,
      joint_fc_layer_params=(cfg.critic_joint_fc_layers if cql
                             else BEHAVIOR_CRITIC_FC),
      device=device, generator=generator)
  actor = make_sac_actor_network(tss.observation, asp,
                                 fc_layer_params=cfg.actor_fc_layers,
                                 device=device, generator=generator)
  kwargs = dict(
      critic_network=critic, actor_network=actor,
      actor_optimizer_fn=adam(cfg.actor_lr if cql else BEHAVIOR_ACTOR_LR),
      critic_optimizer_fn=adam(cfg.critic_lr),
      alpha_optimizer_fn=adam(cfg.alpha_lr),
      gamma=cfg.gamma, target_update_tau=cfg.target_update_tau,
      reward_scale_factor=cfg.reward_scale_factor, generator=generator,
      device=device)
  if not cql:
    return SacAgent(tss, asp, **kwargs)
  return CqlSacAgent(
      tss, asp, cql_alpha=cfg.cql_alpha,
      num_cql_samples=cfg.num_cql_samples,
      softmax_temperature=cfg.softmax_temperature,
      num_bc_steps=cfg.num_bc_steps,
      include_critic_entropy_term=cfg.include_critic_entropy_term,
      reward_noise_variance=cfg.reward_noise_variance, **kwargs)


def snapshot_env_steps(cfg: Config):
  """The env steps at which "mixed" takes its snapshots: each fraction's
  step, as the JAX example computes it (:199-201)."""
  if cfg.dataset_mix != "mixed":
    return []
  return [int(f * cfg.behavior_env_steps) for f in cfg.snapshot_fractions]


def mixed_split(cfg: Config, num_snapshots: int):
  """(random frames, frames per snapshot) of the "mixed" dataset
  (:244-245)."""
  n_random = int(cfg.mixed_random_fraction * cfg.dataset_frames)
  return n_random, (cfg.dataset_frames - n_random) // max(num_snapshots, 1)


def build_env(cfg: Config, make_env=None):
  """(the batched train env, the batched eval env, the device); the device
  is checked before any env is built. `make_env()` builds one host env
  (``suite_gym.load(cfg.env_name)`` unless given)."""
  from agents_tpu_torch.environments import suite_gym
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  make_env = make_env or (lambda: suite_gym.load(cfg.env_name))
  env = BatchedPyEnvironment([make_env() for _ in range(cfg.env_batch_size)])
  env.seed(cfg.seed)
  eval_env = BatchedPyEnvironment(
      [make_env() for _ in range(cfg.num_eval_envs)])
  eval_env.seed(cfg.seed + 1000)
  return env, eval_env, device


def load_offline_replay(cfg: Config, data_spec, data_dir, device):
  """The offline ring, sized from the dataset on disk (not from
  `dataset_frames`: a reused dataset may be larger), and its state filled
  from the dataset."""
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.utils import dataset_io

  replay = UniformReplay(
      data_spec, batch_size=cfg.env_batch_size,
      max_length=max(2, dataset_io.dataset_num_frames(data_dir)),
      device=device)
  return replay, dataset_io.dataset_to_replay(data_dir, data_spec, replay,
                                              replay.init())


def collect(env, policy, observer, frames):
  """Drive `policy` on `env` from a reset until `frames` transitions
  (non-boundary ones, summed over the rows: `PyDriver`'s `max_steps`)
  have gone to `observer`: (the realized return of the episodes that
  ended, 0 if none; the driver's steps, each a frame of every row)."""
  from agents_tpu_torch.drivers.py_driver import PyDriver
  from agents_tpu_torch.metrics import py_metrics

  m = py_metrics.AverageReturnMetric(100)
  ticks = [0]

  def count(_):
    ticks[0] += 1

  PyDriver(env, policy, observers=[observer, m, count],
           max_steps=frames).run(env.reset())
  return float(m.result()), ticks[0]


def train_chunk(cfg: Config, agent, agent_state, replay, rstate, draws):
  """`train_steps_per_call` train steps on samples of the offline ring
  (the JAX example's scanned `train_chunk`): the new state and the last
  loss, left unread on the device."""
  for _ in range(cfg.train_steps_per_call):
    experience, _ = replay.sample(rstate, draws, cfg.offline_batch_size,
                                  num_steps=agent.train_sequence_length)
    agent_state, info = agent.train(agent_state, experience)
  return agent_state, info.loss


def read_comparators(src):
  """(behaviour return, behaviour best, dataset policy return) from an
  earlier run's ``offline.jsonl`` (:164-173)."""
  behavior_return = behavior_best = dataset_return = None
  with open(os.path.join(src, "offline.jsonl")) as f:
    for line in f:
      rec = json.loads(line)
      behavior_return = rec.get("behavior_return", behavior_return)
      behavior_best = rec.get("behavior_best_return", behavior_best)
      dataset_return = rec.get("dataset_policy_return", dataset_return)
  if behavior_best is None:
    behavior_best = behavior_return
  if dataset_return is None:
    raise ValueError(f"{src}: the source run lacks comparators")
  return behavior_return, behavior_best, dataset_return


def train_eval(cfg: Config, make_env=None, stats=None):
  """Phases A, B and C (or C alone, with `reuse_phase_ab`); returns phase
  C's result. `stats`, a dict, receives each phase's counts and seconds."""
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.policies.random_policy import RandomPolicy
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import (AsyncHostDeviceTrainLoop,
                                      JsonlSummaryWriter)
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import dataset_io

  stats = {} if stats is None else stats
  env, eval_env, device = build_env(cfg, make_env)
  tss, asp = env.time_step_spec(), env.action_spec()
  writer = JsonlSummaryWriter(os.path.join(cfg.root_dir, "offline.jsonl"))
  data_dir = os.path.join(cfg.root_dir, "dataset")

  def greedy_eval(agent, agent_state) -> float:
    return evaluate(agent, agent.policy_params(agent_state))

  def evaluate(agent, params) -> float:
    pol = JittedPyPolicy(agent.policy, device=device)
    pol.update_params(params)
    res = metric_utils.compute(
        [py_metrics.AverageReturnMetric(cfg.num_eval_episodes)],
        eval_env, pol, num_episodes=cfg.num_eval_episodes)
    return float(res["AverageReturn"])

  def run_phase_c(behavior_return, behavior_best, dataset_return):
    return phase_c(cfg, tss, asp, device, greedy_eval, writer, data_dir,
                   behavior_return, behavior_best, dataset_return,
                   stats=stats)

  try:
    if cfg.reuse_phase_ab:
      import shutil
      src = os.path.abspath(cfg.reuse_phase_ab)
      if not os.path.exists(data_dir):
        shutil.copytree(os.path.join(src, "dataset"), data_dir)
      behavior_return, behavior_best, dataset_return = read_comparators(src)
      writer.scalar("behavior_return", behavior_return, 0)
      writer.scalar("behavior_best_return", behavior_best, 0)
      writer.scalar("dataset_policy_return", dataset_return, 0)
      print(f"[phase A/B] reused from {src}: behavior_best "
            f"{behavior_best:.0f}, dataset return {dataset_return:.0f}",
            flush=True)
      return run_phase_c(behavior_return, behavior_best, dataset_return)

    # -- Phase A: the behaviour policy (a partially trained SAC) ------------
    t0 = time.time()
    behavior = make_sac(cfg, tss, asp, cql=False, device=device,
                        seed=cfg.seed)
    replay = UniformReplay(tj.trajectory_spec(tss, asp),
                           batch_size=cfg.env_batch_size,
                           max_length=BEHAVIOR_REPLAY_LENGTH, device=device)
    loop = AsyncHostDeviceTrainLoop(
        env, behavior, replay, sample_batch_size=cfg.offline_batch_size,
        train_steps_per_call=BEHAVIOR_TRAIN_STEPS_PER_CALL,
        utd_ratio=cfg.behavior_utd_ratio,
        min_replay_frames=BEHAVIOR_RANDOM_TICKS * cfg.env_batch_size,
        py_metrics=[py_metrics.AverageReturnMetric(20)], device=device)

    # "mixed": copies of the collect parameters as the trainer last
    # published them (the trainer updates its own in place).
    snapshots, snapped_at = [], []
    snap_at = snapshot_env_steps(cfg)

    def snapshot_progress(l):
      if snap_at and len(snapshots) < len(snap_at) \
          and l._env_steps >= snap_at[len(snapshots)]:
        snapshots.append(l.published_params())
        snapped_at.append(l._env_steps)

    out = loop.run(
        total_env_batch_steps=cfg.behavior_env_steps // cfg.env_batch_size,
        seed=cfg.seed, initial_random_steps=BEHAVIOR_RANDOM_TICKS,
        progress_fn=snapshot_progress if snap_at else None,
        progress_every=SNAPSHOT_EVERY_TICKS)
    behavior_state = out["agent_state"]
    if snap_at and len(snapshots) < len(snap_at):
      snapshots.append(copy.deepcopy(
          behavior.collect_policy_params(behavior_state)))
      snapped_at.append(out["env_steps"])
    behavior_return = greedy_eval(behavior, behavior_state)
    stats["phase_a"] = {
        k: v for k, v in out.items() if k not in ("agent_state", "metrics")}
    stats["phase_a"].update(snapshot_env_steps=snapped_at,
                            seconds=time.time() - t0)
    print(f"[phase A] behavior policy @ {cfg.behavior_env_steps} env steps: "
          f"greedy return {behavior_return:.0f} "
          f"({time.time() - t0:.0f}s)", flush=True)
    writer.scalar("behavior_return", behavior_return, 0)

    # -- Phase B: the dataset on disk ---------------------------------------
    t0 = time.time()
    observer = dataset_io.TrajectoryFileObserver(
        data_dir, tj.trajectory_spec(tss, asp),
        frames_per_shard=FRAMES_PER_SHARD)
    collects = stats.setdefault("phase_b", {}).setdefault("collects", [])

    def collect_into_dataset(policy, frames, label):
      ret, ticks = collect(env, policy, observer, frames)
      collects.append({"label": label, "frames": frames, "ticks": ticks,
                       "realized_return": ret})
      print(f"[phase B] {label}: {frames} frames "
            f"(realized return {ret:.0f})", flush=True)
      return ret

    if cfg.dataset_mix == "mixed":
      n_random, n_each = mixed_split(cfg, len(snapshots))
      collect_into_dataset(
          JittedPyPolicy(RandomPolicy(tss, asp), seed=cfg.seed + 11,
                         device=device), n_random, "random policy")
      snap_greedy, snap_realized = [], []
      for i, params in enumerate(snapshots):
        pol = JittedPyPolicy(behavior.collect_policy, seed=cfg.seed + 21 + i,
                             device=device)
        pol.update_params(params)
        snap_realized.append(collect_into_dataset(
            pol, n_each, f"snapshot {i} "
            f"(@{snap_at[i] if i < len(snap_at) else 'end'})"))
        snap_greedy.append(evaluate(behavior, params))
      observer.flush()
      # The comparator "mixed" must beat: the best behaviour policy in the
      # dataset at its greedy best.
      behavior_best = max([behavior_return] + snap_greedy)
      dataset_return = max(snap_realized)
      writer.scalar("behavior_best_return", behavior_best, 0)
      writer.scalar("dataset_policy_return", dataset_return, 0)
      print(f"[phase B] mixed dataset: {cfg.dataset_frames} frames -> "
            f"{data_dir} (behavior-best greedy {behavior_best:.0f}, "
            f"snapshot greedy {['%.0f' % g for g in snap_greedy]}, "
            f"{time.time() - t0:.0f}s)", flush=True)
    else:
      collect_policy = JittedPyPolicy(behavior.collect_policy,
                                      seed=cfg.seed + 1, device=device)
      collect_policy.update_params(
          behavior.collect_policy_params(behavior_state))
      # The dataset policy's own realized return is the offline comparator
      # (the D4RL convention); the greedy behaviour return is reported
      # beside it.
      dataset_return = collect_into_dataset(
          collect_policy, cfg.dataset_frames, "medium policy")
      behavior_best = behavior_return
      observer.flush()
      writer.scalar("dataset_policy_return", dataset_return, 0)
      print(f"[phase B] dataset: {cfg.dataset_frames} frames -> {data_dir} "
            f"(dataset-policy return {dataset_return:.0f}, "
            f"{time.time() - t0:.0f}s)", flush=True)
    stats["phase_b"]["seconds"] = time.time() - t0
    return run_phase_c(behavior_return, behavior_best, dataset_return)
  finally:
    writer.close()
    env.close()
    eval_env.close()


def phase_c(cfg: Config, tss, asp, device, greedy_eval, writer, data_dir,
            behavior_return, behavior_best, dataset_return, stats=None):
  """Offline CQL-SAC over the dataset in `data_dir` (the JAX example's
  `_phase_c`): the same result keys."""
  from agents_tpu_torch.policies.policy_saver import PolicySaver
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils.draws import Draws

  stats = {} if stats is None else stats
  t0 = time.time()
  agent = make_sac(cfg, tss, asp, cql=True, device=device, seed=cfg.seed + 2)
  replay, rstate = load_offline_replay(cfg, tj.trajectory_spec(tss, asp),
                                       data_dir, device)
  print(f"[phase C] replay loaded: {rstate.count} x {cfg.env_batch_size} "
        "frames", flush=True)
  agent_state = agent.init()
  draws = Draws(cfg.seed + 3, device)

  steps, best, train_s = 0, -math.inf, 0.0
  while steps < cfg.offline_train_steps:
    t_chunk = time.perf_counter()
    agent_state, loss = train_chunk(cfg, agent, agent_state, replay, rstate,
                                    draws)
    train_s += time.perf_counter() - t_chunk
    steps += cfg.train_steps_per_call
    if steps % cfg.eval_interval < cfg.train_steps_per_call:
      ret = greedy_eval(agent, agent_state)
      best = max(best, ret)
      loss = float(loss)
      writer.scalar("offline_eval_return", ret, steps)
      writer.scalar("cql_loss", loss, steps)
      print(f"[phase C] offline step {steps}: greedy return {ret:.0f} "
            f"(loss {loss:.2f})", flush=True)

  final_return = greedy_eval(agent, agent_state)
  best = max(best, final_return)
  writer.scalar("offline_eval_return", final_return, cfg.offline_train_steps)
  print(f"[phase C] done in {time.time() - t0:.0f}s", flush=True)
  stats["phase_c"] = {"ring_count": rstate.count, "train_steps": steps,
                      "train_seconds": train_s,
                      "seconds": time.time() - t0}

  saver = PolicySaver(agent.policy, train_step=cfg.offline_train_steps)
  saver.save(os.path.join(cfg.root_dir, "policies", "greedy_policy"),
             agent.policy_params(agent_state))
  return {
      "behavior_return": behavior_return,
      "behavior_best_return": behavior_best,
      "dataset_policy_return": dataset_return,
      "offline_return": final_return,
      "offline_best_return": best,
      # D4RL-convention success: "medium" = the offline agent recovers the
      # data-generating policy's quality (final eval, not best-ever);
      # "mixed" = it clearly beats the best behaviour policy in the
      # dataset.
      "recovers_dataset_policy": bool(final_return >= 0.9 * dataset_return),
      "beats_behavior_best": bool(final_return >= 1.1 * behavior_best),
  }


if __name__ == "__main__":
  from agents_tpu_torch.utils import config as config_lib

  cfg = parse_args(sys.argv[1:], Config(), smoke=SMOKE)
  os.makedirs(cfg.root_dir, exist_ok=True)
  config_lib.save(cfg, os.path.join(cfg.root_dir, "config.json"))
  print(json.dumps(train_eval(cfg)))
