"""PPO on the device CartPole or Pendulum with the PyTorch port
(`agents_tpu_torch`).

The default `Config` is ``examples/ppo_cartpole.py``'s: PPO-clip on
CartPole with B=32 env rows, rollouts of T=128 steps (127 training frames
per row, 4,064 per iteration), 10 epochs x 8 minibatches of 508 frames,
Adam 3e-4, entropy 0.01, clip 0.2, gamma 0.99, lambda 0.95, (64, 64) ReLU
actor and value nets, observation and reward normalizers on.

  --preset=schulman17_pendulum
      ``examples/ppo_halfcheetah.py``'s operating point (:16-41, :64-92) on
      the device Pendulum: B=1, T=2049 (2,048 training frames), 10 epochs x
      32 minibatches of 64, tanh (64, 64) nets, a `NormalProjection` head
      whose state-independent std starts at 0.35 (std bias
      log(exp(0.35) - 1)), Adam(3e-4, eps 1e-5) decayed linearly to 0 over
      the run, gradient clipping 0.5, entropy 0. Cut: Pendulum (obs 3,
      action 1) stands in for HalfCheetah-v5 (obs 17, action 6), which
      needs MuJoCo; the 64-wide layers keep their width, only the first
      and last layers shrink.
  --smoke
      a short run (20 iterations, T=65, 2 epochs x 4 minibatches, 4 eval
      episodes) of either, on the card or with --device cpu.

It writes ``train.jsonl`` (loss, AverageReturn and env-steps/s every
`log_interval` iterations, then EvalAverageReturn) and ``config.json``
under `root_dir` (``runs/ppo_cartpole_torch`` unless set), evaluates the
greedy policy over exactly `num_eval_episodes` episodes on `num_eval_envs`
fresh env rows, and prints a final JSON line.

Usage:
  python examples/ppo_cartpole_torch.py [--preset=schulman17_pendulum]
      [--device cuda|cpu] [--smoke] [--cfg.<field>=<value> ...]
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
  root_dir: str = os.path.join(_REPO, "runs", "ppo_cartpole_torch")
  env: str = "cartpole"                # or "pendulum"
  max_episode_steps: int = 200         # CartPole-v0's and Pendulum-v1's
  env_batch_size: int = 32
  rollout_length: int = 128
  num_iterations: int = 200
  num_epochs: int = 10
  num_minibatches: int = 8
  learning_rate: float = 3e-4
  adam_eps: float = 1e-8               # optax's and torch's default
  lr_decay: bool = False               # linearly to 0 over the run
  entropy_regularization: float = 0.01
  importance_ratio_clipping: float = 0.2
  discount_factor: float = 0.99
  lambda_value: float = 0.95
  gradient_clipping: float = 0.0       # 0: none
  actor_fc_layers: tuple = (64, 64)
  value_fc_layers: tuple = (64, 64)
  activation: str = "relu"             # or "tanh"
  initial_std: float = 0.0             # > 0: NormalProjection's std bias
                                       # log(exp(initial_std) - 1)
  return_buffer: int = 20              # episodes in the AverageReturn deque
  log_interval: int = 20
  num_eval_episodes: int = 30
  num_eval_envs: int = 10
  seed: int = 0
  device: str = "cuda"


SCHULMAN17_PENDULUM = dict(
    env="pendulum", env_batch_size=1, rollout_length=2049,
    num_iterations=489, num_epochs=10, num_minibatches=32,
    learning_rate=3e-4, adam_eps=1e-5, lr_decay=True,
    entropy_regularization=0.0, gradient_clipping=0.5, activation="tanh",
    initial_std=0.35, log_interval=10)

SMOKE = dict(num_iterations=20, log_interval=10, rollout_length=65,
             num_epochs=2, num_minibatches=4, num_eval_episodes=4)

PRESETS = {"schulman17_pendulum": SCHULMAN17_PENDULUM}


def build_env(cfg: Config, batch_size: int):
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole, Pendulum

  if cfg.env == "cartpole":
    env = CartPole(max_episode_steps=cfg.max_episode_steps)
  elif cfg.env == "pendulum":
    env = Pendulum(cfg.max_episode_steps)
  else:
    raise ValueError(f"unknown env {cfg.env!r}")
  return BatchedTorchEnv(env, batch_size, device=cfg.device)


def build_loop(cfg: Config):
  """The env, actor and value networks, agent and on-policy loop of
  `cfg`."""
  import functools

  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.ppo import PPOClipAgent
  from agents_tpu_torch.networks import (NormalProjection,
                                         make_actor_distribution_network,
                                         make_value_network)
  from agents_tpu_torch.train import OnPolicyTrainLoop
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  env = build_env(cfg, cfg.env_batch_size)
  tss, asp = env.time_step_spec(), env.action_spec()
  activation = {"relu": torch.relu, "tanh": torch.tanh}[cfg.activation]
  projection = NormalProjection
  if cfg.initial_std > 0:
    projection = functools.partial(
        NormalProjection,
        std_bias_initializer_value=math.log(math.exp(cfg.initial_std) - 1.0))
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)
  actor = make_actor_distribution_network(
      tss.observation, asp, fc_layer_params=cfg.actor_fc_layers,
      activation=activation, continuous_projection=projection, device=device,
      generator=generator)
  value = make_value_network(tss.observation,
                             fc_layer_params=cfg.value_fc_layers,
                             activation=activation, device=device,
                             generator=generator)
  lr, eps = cfg.learning_rate, cfg.adam_eps
  lr_schedule = None
  if cfg.lr_decay:
    steps = cfg.num_iterations * cfg.num_epochs * cfg.num_minibatches
    lr_schedule = lambda count: 1.0 - min(count, steps) / steps  # noqa: E731
  agent = PPOClipAgent(
      tss, asp, lambda p: torch.optim.Adam(p, lr=lr, eps=eps), actor, value,
      importance_ratio_clipping=cfg.importance_ratio_clipping,
      discount_factor=cfg.discount_factor, lambda_value=cfg.lambda_value,
      num_epochs=cfg.num_epochs, num_minibatches=cfg.num_minibatches,
      entropy_regularization=cfg.entropy_regularization,
      gradient_clipping=cfg.gradient_clipping or None,
      lr_schedule=lr_schedule, device=device)
  return OnPolicyTrainLoop(
      env, agent, metrics=metrics.standard_collect_metrics(cfg.return_buffer),
      rollout_length=cfg.rollout_length, device=device)


def evaluate(cfg: Config, loop, state, seed_or_draws, num_episodes: int,
             max_steps: int = 2000):
  """The greedy policy over exactly `num_episodes` episodes on
  `cfg.num_eval_envs` fresh env rows: {metric name: device scalar}."""
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.utils.draws import as_draws

  return metric_utils.evaluate_torch_env_episodes(
      build_env(cfg, cfg.num_eval_envs), loop.agent.policy,
      loop.agent.policy_params(state.agent_state),
      as_draws(seed_or_draws, loop.device), num_episodes, max_steps)


def train_eval(cfg: Config):
  """Train, log to ``root_dir/train.jsonl``, evaluate greedily.

  Returns (last AverageReturn of the collect deque, greedy eval return).
  """
  loop = build_loop(cfg)
  state = loop.init(cfg.seed)
  os.makedirs(cfg.root_dir, exist_ok=True)

  def write(f, step, **values):
    for key, value in values.items():
      f.write(json.dumps({"step": step, key: value, "t": time.time()}) + "\n")
    f.flush()

  frames = cfg.env_batch_size * cfg.rollout_length
  with open(os.path.join(cfg.root_dir, "train.jsonl"), "w") as f:
    step, t0, avg_return = 0, time.time(), 0.0
    while step < cfg.num_iterations:
      n = min(cfg.log_interval, cfg.num_iterations - step)
      state, losses = loop.run(state, n)
      step += n
      loss = float(losses[-1])
      avg_return = float(loop.results(state)["AverageReturn"])
      sps = step * frames / (time.time() - t0)
      print(f"iter {step}: loss={loss:.4f} AverageReturn={avg_return:.1f} "
            f"({sps:.0f} env-steps/s on {loop.device})", flush=True)
      write(f, step, loss=loss, AverageReturn=avg_return, steps_per_sec=sps)
    out = evaluate(cfg, loop, state, cfg.seed + 101, cfg.num_eval_episodes)
    eval_return = float(out["AverageReturn"])
    write(f, step, EvalAverageReturn=eval_return)
  print(f"final greedy eval ({cfg.num_eval_episodes} episodes): "
        f"{eval_return:.1f}", flush=True)
  return avg_return, eval_return


def parse_ppo_args(argv) -> Config:
  """--preset=schulman17_pendulum first, then `parse_args`'s --smoke,
  --device and --cfg.<field>=<value>."""
  cfg, rest = Config(), []
  for arg in argv:
    if arg.startswith("--preset="):
      preset = arg.split("=", 1)[1]
      if preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r}; valid: "
                         f"{sorted(PRESETS)}")
      cfg = dataclasses.replace(cfg, **PRESETS[preset])
    else:
      rest.append(arg)
  return parse_args(rest, cfg, smoke=SMOKE)


if __name__ == "__main__":
  cfg = parse_ppo_args(sys.argv[1:])
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  final, eval_return = train_eval(cfg)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed}))
