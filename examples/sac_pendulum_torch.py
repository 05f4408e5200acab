"""SAC on the on-device Pendulum with the PyTorch port (`agents_tpu_torch`).

The default `Config` is the SAC bench point: the agent and replay of
``bench.py:sac_live_probe`` (:57-98) on the device Pendulum in place of
host HalfCheetah. That is haarnoja18's (256, 256) actor and critic, Adam
3e-4 for each of the actor, the twin critics and log alpha, tau 0.005
every step, gamma 0.99, reward scale 0.1, sample 256, B=32 env rows with
a ring of 4096 per row, UTD 1.0 (1 collect step of 32 env steps and 32
train steps per iteration) and 64 initial collect steps (the probe's
``min_replay_frames = 64 * B``).

  --preset=live  the configuration of ``tests/test_live_windows.py:89-123``:
                 B=8, ring 8192, sample 256, 4 train steps per iteration,
                 (64, 64) actor and critic, reward scale 1.0, 128 initial
                 collect steps, 8,000 iterations. Its pass window
                 (``return_windows.py:101``) is a last-20 return of -250
                 or more within 8,000 iterations.
  --smoke        a short run at a small width (B=8, ring 256, sample 32,
                 (32, 32), 2 train steps, 200 iterations), on the card or
                 with --device cpu.

Like ``examples/dqn_cartpole_torch.py`` it writes ``train.jsonl`` and
``config.json`` under `root_dir` (``runs/sac_pendulum_torch`` unless set),
evaluates greedily over `num_eval_episodes` and prints a final JSON line.

Usage:
  python examples/sac_pendulum_torch.py [--preset=live] [--device cuda|cpu]
      [--smoke] [--cfg.<field>=<value> ...]
"""
import dataclasses
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from examples.dqn_cartpole_torch import parse_args, train_eval  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "sac_pendulum_torch")
  max_episode_steps: int = 200         # Pendulum-v1's time limit
  env_batch_size: int = 32
  num_iterations: int = 2000
  initial_collect_steps: int = 64
  replay_capacity: int = 4096          # per env row
  sample_batch_size: int = 256
  train_steps_per_iteration: int = 32
  actor_fc_layers: tuple = (256, 256)
  critic_joint_fc_layers: tuple = (256, 256)
  actor_lr: float = 3e-4
  critic_lr: float = 3e-4
  alpha_lr: float = 3e-4
  gamma: float = 0.99
  target_update_tau: float = 0.005
  reward_scale_factor: float = 0.1
  return_buffer: int = 20              # episodes in the AverageReturn deque
  log_interval: int = 500
  num_eval_episodes: int = 30
  seed: int = 0
  device: str = "cuda"


LIVE = dict(env_batch_size=8, replay_capacity=8192, sample_batch_size=256,
            train_steps_per_iteration=4, actor_fc_layers=(64, 64),
            critic_joint_fc_layers=(64, 64), reward_scale_factor=1.0,
            initial_collect_steps=128, num_iterations=8000,
            log_interval=250)

SMOKE = dict(env_batch_size=8, replay_capacity=256, sample_batch_size=32,
             train_steps_per_iteration=2, actor_fc_layers=(32, 32),
             critic_joint_fc_layers=(32, 32), initial_collect_steps=16,
             num_iterations=200, log_interval=100, num_eval_episodes=4)


def build_loop(cfg: Config):
  """The env, agent, replay and fused loop of `cfg`."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import Pendulum
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_sac_actor_network)
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  env = BatchedTorchEnv(Pendulum(cfg.max_episode_steps), cfg.env_batch_size,
                        device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)
  actor = make_sac_actor_network(tss.observation, asp,
                                 fc_layer_params=cfg.actor_fc_layers,
                                 device=device, generator=generator)
  critic = make_critic_network(tss.observation, asp,
                               joint_fc_layer_params=cfg.critic_joint_fc_layers,
                               device=device, generator=generator)

  def adam(lr):
    return lambda params: torch.optim.Adam(params, lr=lr)

  agent = SacAgent(tss, asp, critic, actor, adam(cfg.actor_lr),
                   adam(cfg.critic_lr), adam(cfg.alpha_lr),
                   target_update_tau=cfg.target_update_tau, gamma=cfg.gamma,
                   reward_scale_factor=cfg.reward_scale_factor,
                   generator=generator, device=device)
  replay = UniformReplay(tj.trajectory_spec(tss, asp),
                         batch_size=cfg.env_batch_size,
                         max_length=cfg.replay_capacity, device=device)
  return FusedTrainLoop(
      env, agent, replay,
      metrics=metrics.standard_collect_metrics(cfg.return_buffer),
      sample_batch_size=cfg.sample_batch_size,
      train_steps_per_iteration=cfg.train_steps_per_iteration, device=device)


def parse_sac_args(argv) -> Config:
  """--preset=live first, then `parse_args`'s --smoke, --device and
  --cfg.<field>=<value>."""
  cfg, rest = Config(), []
  for arg in argv:
    if arg.startswith("--preset="):
      preset = arg.split("=", 1)[1]
      if preset != "live":
        raise SystemExit(f"unknown preset {preset!r}")
      cfg = dataclasses.replace(cfg, **LIVE)
    else:
      rest.append(arg)
  return parse_args(rest, cfg, smoke=SMOKE)


if __name__ == "__main__":
  cfg = parse_sac_args(sys.argv[1:])
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  final, eval_return = train_eval(cfg, build=build_loop)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed}))
