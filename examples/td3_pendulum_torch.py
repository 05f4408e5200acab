"""TD3, DDPG or QtOpt on the on-device Pendulum with the PyTorch port.

The default `Config` is the TD3 bench point: the SAC bench point's
construction (``examples/sac_pendulum_torch.py``: B=32 env rows with a ring
of 4096 per row, sample 256, 32 train steps per iteration, 64 initial
collect steps) with Fujimoto et al.'s TD3 settings (the ``sfujim/TD3``
reference code): (256, 256) actor and critic, Adam 3e-4, tau 0.005 every
step, gamma 0.99, target noise 0.2 clipped at 0.5, the actor stepped every
2 train steps, Gaussian exploration noise 0.1, reward scale 1.0.

  --agent=ddpg   DDPG at the same widths and replay, its collect policy
                 Ornstein-Uhlenbeck noise with damping 0.15 and stddev 0.2
                 (Lillicrap et al. 2015's theta and sigma); set
                 --cfg.dqda_clipping to clip dQ/da (0 leaves it off).
  --agent=qtopt  QtOpt at the same env, replay, critic width, learning
                 rate, gamma and target update, with the JAX package's
                 `QtOptAgent` defaults otherwise: CEM over the target critic
                 with 32 samples, 4 elites and 3 iterations, clipped double Q
                 over two delayed targets copied every 5 steps, epsilon-
                 greedy collect at 0.1, the Huber loss.
  --preset=live  the SAC live construction of
                 ``tests/test_live_windows.py:89-123`` with the agent above:
                 B=8, ring 8192, sample 256, 4 train steps per iteration,
                 (64, 64) actor and critic, 128 initial collect steps,
                 8,000 iterations.
  --smoke        a short run at a small width, on the card or with
                 --device cpu.

Like the other examples it writes ``train.jsonl`` and ``config.json``
under `root_dir` (``runs/td3_pendulum_torch`` unless set), evaluates
greedily over `num_eval_episodes` and prints a final JSON line.

Usage:
  python examples/td3_pendulum_torch.py [--agent=td3|ddpg|qtopt]
      [--preset=live] [--device cuda|cpu] [--smoke]
      [--cfg.<field>=<value> ...]
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
  root_dir: str = os.path.join(_REPO, "runs", "td3_pendulum_torch")
  agent: str = "td3"                   # or "ddpg" or "qtopt"
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
  gamma: float = 0.99
  target_update_tau: float = 0.005
  target_update_period: int = 1
  reward_scale_factor: float = 1.0
  # TD3
  actor_update_period: int = 2
  target_policy_noise: float = 0.2
  target_policy_noise_clip: float = 0.5
  exploration_noise_std: float = 0.1
  # DDPG
  ou_stddev: float = 0.2
  ou_damping: float = 0.15
  dqda_clipping: float = 0.0           # 0: off
  return_buffer: int = 20              # episodes in the AverageReturn deque
  log_interval: int = 500
  num_eval_episodes: int = 30
  seed: int = 0
  device: str = "cuda"


LIVE = dict(env_batch_size=8, replay_capacity=8192, sample_batch_size=256,
            train_steps_per_iteration=4, actor_fc_layers=(64, 64),
            critic_joint_fc_layers=(64, 64), initial_collect_steps=128,
            num_iterations=8000, log_interval=250)

SMOKE = dict(env_batch_size=8, replay_capacity=256, sample_batch_size=32,
             train_steps_per_iteration=2, actor_fc_layers=(32, 32),
             critic_joint_fc_layers=(32, 32), initial_collect_steps=16,
             num_iterations=200, log_interval=100, num_eval_episodes=4)


def build_agent(cfg: Config, tss, asp, device, generator):
  """The TD3, DDPG or QtOpt agent of `cfg`, its networks drawn from
  `generator`."""
  import torch

  from agents_tpu_torch.agents.ddpg import DdpgAgent
  from agents_tpu_torch.agents.qtopt import QtOptAgent
  from agents_tpu_torch.agents.td3 import Td3Agent
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_deterministic_actor_network)

  def adam(lr):
    return lambda params: torch.optim.Adam(params, lr=lr)

  common = dict(target_update_tau=cfg.target_update_tau,
                target_update_period=cfg.target_update_period,
                gamma=cfg.gamma, reward_scale_factor=cfg.reward_scale_factor,
                device=device)
  if cfg.agent == "qtopt":
    critic = make_critic_network(
        tss.observation, asp, joint_fc_layer_params=cfg.critic_joint_fc_layers,
        device=device, generator=generator)
    return QtOptAgent(tss, asp, critic, adam(cfg.critic_lr), **common)
  actor = make_deterministic_actor_network(
      tss.observation, asp, fc_layer_params=cfg.actor_fc_layers,
      device=device, generator=generator)
  critic = make_critic_network(tss.observation, asp,
                               joint_fc_layer_params=cfg.critic_joint_fc_layers,
                               device=device, generator=generator)
  if cfg.agent == "td3":
    return Td3Agent(tss, asp, actor, critic, adam(cfg.actor_lr),
                    adam(cfg.critic_lr),
                    exploration_noise_std=cfg.exploration_noise_std,
                    actor_update_period=cfg.actor_update_period,
                    target_policy_noise=cfg.target_policy_noise,
                    target_policy_noise_clip=cfg.target_policy_noise_clip,
                    generator=generator, **common)
  if cfg.agent == "ddpg":
    return DdpgAgent(tss, asp, actor, critic, adam(cfg.actor_lr),
                     adam(cfg.critic_lr), ou_stddev=cfg.ou_stddev,
                     ou_damping=cfg.ou_damping,
                     dqda_clipping=cfg.dqda_clipping or None, **common)
  raise ValueError(f"unknown agent {cfg.agent!r}")


def build_loop(cfg: Config):
  """The env, agent, replay and fused loop of `cfg`."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import Pendulum
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
  agent = build_agent(cfg, tss, asp, device, generator)
  replay = UniformReplay(tj.trajectory_spec(tss, asp),
                         batch_size=cfg.env_batch_size,
                         max_length=cfg.replay_capacity, device=device)
  return FusedTrainLoop(
      env, agent, replay,
      metrics=metrics.standard_collect_metrics(cfg.return_buffer),
      sample_batch_size=cfg.sample_batch_size,
      train_steps_per_iteration=cfg.train_steps_per_iteration, device=device)


def parse_td3_args(argv) -> Config:
  """--agent= and --preset=live first, then `parse_args`'s --smoke,
  --device and --cfg.<field>=<value>."""
  cfg, rest = Config(), []
  for arg in argv:
    if arg.startswith("--agent="):
      agent = arg.split("=", 1)[1]
      if agent not in ("td3", "ddpg", "qtopt"):
        raise SystemExit(f"unknown agent {agent!r}")
      cfg = dataclasses.replace(cfg, agent=agent)
    elif arg.startswith("--preset="):
      preset = arg.split("=", 1)[1]
      if preset != "live":
        raise SystemExit(f"unknown preset {preset!r}")
      cfg = dataclasses.replace(cfg, **LIVE)
    else:
      rest.append(arg)
  return parse_args(rest, cfg, smoke=SMOKE)


if __name__ == "__main__":
  cfg = parse_td3_args(sys.argv[1:])
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  final, eval_return = train_eval(cfg, build=build_loop)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed, "agent": cfg.agent}))
