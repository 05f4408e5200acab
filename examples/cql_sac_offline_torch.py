"""Offline RL on the device Pendulum with the PyTorch port: collect ->
dataset on disk -> offline CQL-SAC (or behavioural cloning) -> greedy eval.

The default `Config` is the pipeline of ``tests/test_cql_offline_e2e.py``:

  A. a behaviour policy: SAC with (64, 64) actor and critics, Adam 3e-4,
     tau 0.005, B=8 env rows, ring 4096, 2 train steps of 128 per
     iteration and 128 initial collect steps, checked every 250 iterations
     until its last-20 return passes -250 (at most 6,000 iterations);
  B. a "medium" dataset: 2,048 lockstep steps of the 8 rows by
     ``GaussianPolicy(GreedyPolicy(behaviour), 0.1)``, written to npz
     shards of 512 frames by `dataset_io.TrajectoryFileObserver`;
  C. `dataset_io.dataset_to_replay` into a ring sized by
     `dataset_num_frames`, then `CqlSacAgent` (cql_alpha 10, 8 samples,
     1,000 behavioural-cloning actor steps, softmax temperature 50,
     initial alpha 0.1) for 3,000 steps of 256 transitions, with a greedy
     eval over 10 episodes after the BC steps and at the end.

  --agent=bc        phase C trains `BehavioralCloningAgent` on the SAC
                    actor instead (same steps, samples and learning rate),
                    greedy eval over `num_eval_episodes`.
  --preset=kumar20  ``examples/cql_sac_offline.py``'s Config widths and CQL
                    settings: actor (256, 256), critic (256, 256, 256),
                    sample 256, 10 CQL samples, cql_alpha 5.0, temperature
                    1.0, reward scale 0.1, 20,000 BC steps of 60,000, over
                    a Pendulum dataset of 32 rows x 3,125 frames (the
                    100,000 frames of that Config) from a (256, 256) SAC
                    behaviour run at UTD 1.0 (2,250 iterations of 32 rows
                    and 32 train steps: its 72,000 env steps). Cut:
                    HalfCheetah-v5 -> the device Pendulum (no MuJoCo on
                    the card's machine, no D4RL), and so a dataset of
                    Pendulum's obs 3 / action 1 for HalfCheetah's 17 / 6.
  --smoke           a short run at a small width.

It writes ``config.json``, the dataset under ``dataset/`` and
``offline.jsonl`` under `root_dir` (``runs/cql_sac_offline_torch`` unless
set), and prints a final JSON line.

Usage:
  python examples/cql_sac_offline_torch.py [--agent=cql|bc]
      [--preset=kumar20] [--device cuda|cpu] [--smoke]
      [--cfg.<field>=<value> ...]
"""
import dataclasses
import json
import math
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from examples.dqn_cartpole_torch import parse_args  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "cql_sac_offline_torch")
  agent: str = "cql"                   # or "bc"
  max_episode_steps: int = 200
  env_batch_size: int = 8
  actor_fc_layers: tuple = (64, 64)
  critic_joint_fc_layers: tuple = (64, 64)
  behavior_critic_joint_fc_layers: tuple = (64, 64)
  actor_lr: float = 3e-4
  critic_lr: float = 3e-4
  alpha_lr: float = 3e-4
  gamma: float = 0.99
  target_update_tau: float = 0.005
  reward_scale_factor: float = 1.0
  # Phase A: the behaviour policy.
  behavior_replay_capacity: int = 4096
  behavior_sample_batch_size: int = 128
  behavior_train_steps: int = 2
  behavior_initial_collect_steps: int = 128
  behavior_iterations: int = 6000
  behavior_chunk: int = 250
  behavior_gate: float = -250.0
  # Phase B: the dataset (lockstep steps of all rows).
  dataset_frames: int = 2048
  dataset_noise: float = 0.1
  frames_per_shard: int = 512
  # Phase C: offline training.
  offline_train_steps: int = 3000
  offline_batch_size: int = 256
  cql_alpha: float = 10.0
  num_cql_samples: int = 8
  softmax_temperature: float = 50.0
  num_bc_steps: int = 1000
  initial_alpha: float = 0.1
  include_critic_entropy_term: bool = False
  reward_noise_variance: float = 0.0
  num_eval_episodes: int = 10
  seed: int = 0
  device: str = "cuda"


KUMAR20 = dict(env_batch_size=32, actor_fc_layers=(256, 256),
               critic_joint_fc_layers=(256, 256, 256),
               behavior_critic_joint_fc_layers=(256, 256),
               reward_scale_factor=0.1, behavior_replay_capacity=16384,
               behavior_sample_batch_size=256, behavior_train_steps=32,
               behavior_initial_collect_steps=256, behavior_iterations=2250,
               behavior_gate=0.0, dataset_frames=3125, frames_per_shard=1024,
               offline_train_steps=60_000, cql_alpha=5.0, num_cql_samples=10,
               softmax_temperature=1.0, num_bc_steps=20_000,
               initial_alpha=1.0)

SMOKE = dict(actor_fc_layers=(16, 16), critic_joint_fc_layers=(16, 16),
             behavior_critic_joint_fc_layers=(16, 16),
             behavior_replay_capacity=256, behavior_sample_batch_size=32,
             behavior_initial_collect_steps=16, behavior_iterations=20,
             behavior_chunk=10, dataset_frames=64, frames_per_shard=16,
             offline_train_steps=20, offline_batch_size=32, num_cql_samples=2,
             num_bc_steps=10, num_eval_episodes=4)


def build_env(cfg: Config):
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import Pendulum
  from agents_tpu_torch.utils.device import resolve_device

  return BatchedTorchEnv(Pendulum(cfg.max_episode_steps), cfg.env_batch_size,
                         device=resolve_device(cfg.device))


def _adam(lr):
  import torch
  return lambda params: torch.optim.Adam(params, lr=lr)


def build_agent(cfg: Config, env, kind: str, seed: int):
  """The behaviour SAC ("sac"), the offline `CqlSacAgent` ("cql") or the
  `BehavioralCloningAgent` ("bc") of `cfg`, networks drawn from `seed`."""
  import torch

  from agents_tpu_torch.agents.behavioral_cloning import \
      BehavioralCloningAgent
  from agents_tpu_torch.agents.cql import CqlSacAgent
  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_sac_actor_network)

  tss, asp, device = env.time_step_spec(), env.action_spec(), env.device
  generator = torch.Generator(device=device)
  generator.manual_seed(seed)
  make_actor = lambda: make_sac_actor_network(  # noqa: E731
      tss.observation, asp, fc_layer_params=cfg.actor_fc_layers,
      device=device, generator=generator)
  if kind == "bc":
    return BehavioralCloningAgent(tss, asp, make_actor(),
                                  _adam(cfg.actor_lr), device=device)
  # The critic is drawn first, then the actor.
  critic = make_critic_network(
      tss.observation, asp,
      joint_fc_layer_params=(cfg.behavior_critic_joint_fc_layers
                             if kind == "sac" else cfg.critic_joint_fc_layers),
      device=device, generator=generator)
  actor = make_actor()
  kwargs = dict(
      critic_network=critic, actor_network=actor,
      actor_optimizer_fn=_adam(cfg.actor_lr),
      critic_optimizer_fn=_adam(cfg.critic_lr),
      alpha_optimizer_fn=_adam(cfg.alpha_lr),
      target_update_tau=cfg.target_update_tau, gamma=cfg.gamma,
      reward_scale_factor=cfg.reward_scale_factor, generator=generator,
      device=device)
  if kind == "sac":
    return SacAgent(tss, asp, **kwargs)
  return CqlSacAgent(
      tss, asp, cql_alpha=cfg.cql_alpha, num_cql_samples=cfg.num_cql_samples,
      num_bc_steps=cfg.num_bc_steps,
      softmax_temperature=cfg.softmax_temperature,
      include_critic_entropy_term=cfg.include_critic_entropy_term,
      reward_noise_variance=cfg.reward_noise_variance,
      initial_log_alpha=math.log(cfg.initial_alpha), **kwargs)


def greedy_eval(cfg, env, agent, agent_state, num_episodes, seed):
  """Greedy return over exactly `num_episodes` episodes on a fresh reset
  of `env`'s rows: (return, episodes counted)."""
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.utils.draws import Draws

  out = metric_utils.evaluate_torch_env_episodes(
      env, agent.policy, agent.policy_params(agent_state),
      Draws(seed, env.device), num_episodes, max_steps=2000)
  return float(out["AverageReturn"]), out["_episodes_completed"]


def behavior_phase(cfg: Config, env):
  """Phase A: train the behaviour SAC until its last-20 return passes
  `behavior_gate` (checked every `behavior_chunk` iterations). Returns
  (agent, agent state, iterations, last-20 return)."""
  from agents_tpu_torch import metrics
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj

  agent = build_agent(cfg, env, "sac", cfg.seed)
  replay = UniformReplay(
      tj.trajectory_spec(env.time_step_spec(), env.action_spec()),
      cfg.env_batch_size, cfg.behavior_replay_capacity, device=env.device)
  loop = FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(20),
                        sample_batch_size=cfg.behavior_sample_batch_size,
                        train_steps_per_iteration=cfg.behavior_train_steps,
                        device=env.device)
  state = loop.init(cfg.seed,
                    initial_collect_steps=cfg.behavior_initial_collect_steps)
  iterations, ret = 0, -math.inf
  while iterations < cfg.behavior_iterations:
    state, _ = loop.run(state, cfg.behavior_chunk)
    iterations += cfg.behavior_chunk
    ret = float(loop.results(state)["AverageReturn"])
    if ret > cfg.behavior_gate:
      break
  return agent, state.agent_state, iterations, ret


def dataset_phase(cfg: Config, env, behavior, behavior_state, data_dir):
  """Phase B: `dataset_frames` lockstep steps of the noisy greedy
  behaviour policy into a ring, then written frame by frame (``[B, ...]``
  each, oldest first) through `TrajectoryFileObserver`. Returns the
  realized average return of the collect."""
  import torch

  from agents_tpu_torch.drivers import TorchDriver
  from agents_tpu_torch.metrics import torch_metrics
  from agents_tpu_torch.policies import GaussianPolicy, GreedyPolicy
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import dataset_io, nest_utils
  from agents_tpu_torch.utils.draws import Draws

  data_spec = tj.trajectory_spec(env.time_step_spec(), env.action_spec())
  policy = GaussianPolicy(GreedyPolicy(behavior.policy),
                          scale=cfg.dataset_noise)
  replay = UniformReplay(data_spec, cfg.env_batch_size, cfg.dataset_frames,
                         device=env.device)
  avg = torch_metrics.AverageReturnMetric(100)
  driver = TorchDriver(env, policy, observers=[replay.add_batch, avg.update])
  draws = Draws(cfg.seed + 11, env.device)
  _, (rstate, avg_state) = driver.run(
      behavior.policy_params(behavior_state), driver.init(draws),
      (replay.init(), avg.init(cfg.env_batch_size, env.device)), draws,
      cfg.dataset_frames)
  frames = nest_utils.tree_map(lambda x: x.cpu().numpy(),
                               replay.gather_all(rstate))   # [B, T, ...]
  observer = dataset_io.TrajectoryFileObserver(
      data_dir, data_spec, frames_per_shard=cfg.frames_per_shard)
  for t in range(cfg.dataset_frames):
    observer(nest_utils.tree_map(lambda x: x[:, t], frames))
  observer.flush()
  with torch.no_grad():
    return float(avg.result(avg_state))


def offline_phase(cfg: Config, env, data_dir, kind=None, on_step=None):
  """Phase C: the dataset streamed into a ring sized by
  `dataset_num_frames`, then `offline_train_steps` train steps of the
  offline agent (`cfg.agent` unless `kind` is given). `on_step(step, agent,
  agent_state)` is called after each step. Returns (agent, agent state,
  losses [n] on the device, replay state)."""
  import torch

  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import dataset_io
  from agents_tpu_torch.utils.draws import Draws

  kind = kind or cfg.agent
  data_spec = tj.trajectory_spec(env.time_step_spec(), env.action_spec())
  replay = UniformReplay(data_spec, cfg.env_batch_size,
                         max(2, dataset_io.dataset_num_frames(data_dir)),
                         device=env.device)
  rstate = dataset_io.dataset_to_replay(data_dir, data_spec, replay,
                                        replay.init())
  agent = build_agent(cfg, env, kind, cfg.seed + 2)
  agent_state = agent.init()
  draws = Draws(cfg.seed + 3, env.device)
  losses = []
  for step in range(1, cfg.offline_train_steps + 1):
    experience, _ = replay.sample(rstate, draws, cfg.offline_batch_size,
                                  num_steps=agent.train_sequence_length)
    agent_state, info = agent.train(agent_state, experience)
    losses.append(info.loss)
    if on_step is not None:
      on_step(step, agent, agent_state)
  return agent, agent_state, torch.stack(losses), rstate


def train_eval(cfg: Config):
  """Phases A, B and C; the returns along the way, written to
  ``offline.jsonl``."""
  t0 = time.time()
  env = build_env(cfg)
  data_dir = os.path.join(cfg.root_dir, "dataset")
  behavior, behavior_state, iterations, collect_return = behavior_phase(
      cfg, env)
  behavior_return, _ = greedy_eval(cfg, env, behavior, behavior_state,
                                   cfg.num_eval_episodes, cfg.seed + 7)
  print(f"[phase A] behaviour SAC: {iterations} iterations, last-20 return "
        f"{collect_return:.1f}, greedy {behavior_return:.1f}", flush=True)
  dataset_return = dataset_phase(cfg, env, behavior, behavior_state, data_dir)
  print(f"[phase B] {cfg.dataset_frames} x {cfg.env_batch_size} frames -> "
        f"{data_dir} (realized return {dataset_return:.1f})", flush=True)
  out = {"behavior_iterations": iterations,
         "behavior_return": behavior_return,
         "dataset_policy_return": dataset_return}

  def on_step(step, agent, agent_state):
    if cfg.agent == "cql" and step == cfg.num_bc_steps:
      out["bc_phase_return"], _ = greedy_eval(
          cfg, env, agent, agent_state, cfg.num_eval_episodes, cfg.seed + 7)
      print(f"[phase C] after {step} BC steps: greedy "
            f"{out['bc_phase_return']:.1f}", flush=True)

  agent, agent_state, losses, _ = offline_phase(cfg, env, data_dir,
                                                on_step=on_step)
  out["offline_return"], out["eval_episodes"] = greedy_eval(
      cfg, env, agent, agent_state, cfg.num_eval_episodes, cfg.seed + 7)
  out["last_loss"] = float(losses[-1])
  out["seconds"] = time.time() - t0
  print(f"[phase C] {cfg.agent} after {cfg.offline_train_steps} steps: "
        f"greedy {out['offline_return']:.1f}", flush=True)
  with open(os.path.join(cfg.root_dir, "offline.jsonl"), "w") as f:
    for key, value in out.items():
      f.write(json.dumps({key: value}) + "\n")
  return out


def parse_offline_args(argv) -> Config:
  """--agent= and --preset=kumar20 first, then `parse_args`'s --smoke,
  --device and --cfg.<field>=<value>."""
  cfg, rest = Config(), []
  for arg in argv:
    if arg.startswith("--agent="):
      agent = arg.split("=", 1)[1]
      if agent not in ("cql", "bc"):
        raise SystemExit(f"unknown agent {agent!r}")
      cfg = dataclasses.replace(cfg, agent=agent)
    elif arg.startswith("--preset="):
      preset = arg.split("=", 1)[1]
      if preset != "kumar20":
        raise SystemExit(f"unknown preset {preset!r}")
      cfg = dataclasses.replace(cfg, **KUMAR20)
    else:
      rest.append(arg)
  return parse_args(rest, cfg, smoke=SMOKE)


if __name__ == "__main__":
  cfg = parse_offline_args(sys.argv[1:])
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  print(json.dumps({**train_eval(cfg), "agent": cfg.agent, "seed": cfg.seed}))
