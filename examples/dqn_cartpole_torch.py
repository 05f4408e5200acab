"""DQN on CartPole with the PyTorch port (`agents_tpu_torch`).

The port's twin of ``examples/dqn_cartpole.py``: the same `Config`
(plus `device`), the same fused loop (one collect step and one train step
per iteration) driven through the port's `Learner`, greedy eval over
`num_eval_episodes` at the end. The `Learner` restores the whole loop
state from the newest checkpoint under ``root_dir/train/checkpoints``
when there is one, checkpoints every `checkpoint_interval` iterations (0
or less: never) and once more at the end, and writes ``train.jsonl``
through its `JsonlSummaryWriter` every `log_interval` iterations: loss,
``loss_extra/*``, ``collect/*`` and steps_per_sec (iterations per
second), beside the example's AverageReturn and, at the end,
EvalAverageReturn. A resumed run appends to ``train.jsonl``; a fresh one
starts it anew. ``config.json`` goes to `root_dir`
(``runs/dqn_cartpole_torch`` in the repository unless set), and the last
line printed is the JAX example's JSON line.

With ``--cfg.policy_interval=N`` (N > 0) a `PolicyCheckpointTrigger`
exports ``root_dir/policies/{greedy_policy,collect_policy,policy}`` every
N iterations (the whole artifact the first time, params only after),
which ``examples/eval_job_torch.py`` polls.

Usage:
  python examples/dqn_cartpole_torch.py [--device cuda|cpu] [--smoke]
      [--cfg.policy_interval=1000] [--cfg.num_iterations=20000]
      [--cfg.<field>=<value> ...]
"""
import dataclasses
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "dqn_cartpole_torch")
  env_batch_size: int = 32
  num_iterations: int = 20000
  initial_collect_steps: int = 100
  replay_capacity: int = 4096          # per env row (~131k frames total)
  sample_batch_size: int = 64
  learning_rate: float = 1e-3
  epsilon_greedy: float = 0.1
  gamma: float = 0.99
  target_update_tau: float = 0.05
  target_update_period: int = 5
  fc_layer_params: tuple = (100, 50)
  log_interval: int = 2000
  checkpoint_interval: int = 10000     # <= 0: no checkpoints
  policy_interval: int = 0             # <= 0: no policy exports
  num_eval_episodes: int = 30
  seed: int = 0
  device: str = "cuda"


def build_loop(cfg: Config):
  """The env, agent, replay and fused loop of `cfg`."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import common
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  env = BatchedTorchEnv(CartPole(), cfg.env_batch_size, device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)
  qnet = make_q_network(tss.observation, asp,
                        fc_layer_params=cfg.fc_layer_params, device=device,
                        generator=generator)
  lr = cfg.learning_rate
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=lr),
                   epsilon_greedy=cfg.epsilon_greedy, gamma=cfg.gamma,
                   target_update_tau=cfg.target_update_tau,
                   target_update_period=cfg.target_update_period,
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   device=device)
  replay = UniformReplay(tj.trajectory_spec(tss, asp),
                         batch_size=cfg.env_batch_size,
                         max_length=cfg.replay_capacity, device=device)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(20),
                        sample_batch_size=cfg.sample_batch_size,
                        device=device)


def train_eval(cfg, build=build_loop):
  """Train `build(cfg)`'s loop through a `Learner` under `root_dir` (from
  its newest checkpoint, or from the start), log to
  ``root_dir/train.jsonl``, evaluate greedily. With ``cfg.policy_interval``
  > 0, export the policy trio every `policy_interval` iterations.

  Returns (last AverageReturn of the collect deque, greedy eval return).
  """
  from agents_tpu_torch.train import (JsonlSummaryWriter, Learner,
                                      PolicyCheckpointTrigger)

  loop = build(cfg)
  state = loop.init(cfg.seed, initial_collect_steps=cfg.initial_collect_steps)
  os.makedirs(cfg.root_dir, exist_ok=True)
  # The pixel and SAC examples' Configs, like their JAX twins', have no
  # checkpoint or policy interval: they neither checkpoint nor export.
  learner = Learner(cfg.root_dir, loop=loop, initial_state=state,
                    checkpoint_interval=getattr(cfg, "checkpoint_interval",
                                                0),
                    summary_interval=cfg.log_interval)
  log_path = os.path.join(cfg.root_dir, "train.jsonl")
  if learner.global_step == 0 and os.path.exists(log_path):
    os.remove(log_path)          # a fresh run starts its log anew
  writer = JsonlSummaryWriter(log_path)
  learner.summary_writer = writer
  policy_interval = getattr(cfg, "policy_interval", 0)
  if policy_interval > 0:
    learner.triggers.append(PolicyCheckpointTrigger(
        cfg.root_dir, loop.agent, lambda: learner.state.agent_state,
        policy_interval))

  start, t0 = learner.global_step, time.time()
  avg_return = float(loop.results(learner.state)["AverageReturn"])
  while learner.global_step < cfg.num_iterations:
    n = min(cfg.log_interval, cfg.num_iterations - learner.global_step)
    loss = learner.run(n)
    avg_return = float(loop.results(learner.state)["AverageReturn"])
    sps = ((learner.global_step - start) * cfg.env_batch_size
           / (time.time() - t0))
    print(f"iter {learner.global_step}: loss={loss:.4f} "
          f"AverageReturn={avg_return:.1f} ({sps:.0f} env-steps/s on "
          f"{loop.device})", flush=True)
    writer.scalar("AverageReturn", avg_return, learner.global_step)
  learner.checkpoint()
  eval_out = loop.evaluate(learner.state, cfg.seed + 101,
                           num_episodes=cfg.num_eval_episodes,
                           max_steps=2000)
  eval_return = float(eval_out["AverageReturn"])
  writer.scalar("EvalAverageReturn", eval_return, learner.global_step)
  writer.close()
  print(f"final greedy eval ({cfg.num_eval_episodes} episodes): "
        f"{eval_return:.1f}", flush=True)
  return avg_return, eval_return


SMOKE = dict(num_iterations=2000, log_interval=500)


def parse_args(argv, cfg, smoke=SMOKE):
  """--smoke (the `smoke` fields), --device DEV and --cfg.<field>=<value>
  overrides of the dataclass `cfg` (`agents_tpu_torch.utils.config`; a
  tuple of tuples is written ``32x8x4,64x4x2``)."""
  from agents_tpu_torch.utils import config as config_lib

  argv = list(argv)
  if "--smoke" in argv:
    argv.remove("--smoke")
    cfg = dataclasses.replace(cfg, **smoke)
  overrides, i = [], 0
  while i < len(argv):
    arg = argv[i]
    if arg == "--device":
      cfg = dataclasses.replace(cfg, device=argv[i + 1])
      i += 2
      continue
    if arg.startswith("--device="):
      cfg = dataclasses.replace(cfg, device=arg.split("=", 1)[1])
    elif arg.startswith("--cfg.") and "=" in arg:
      overrides.append(arg)
    else:
      raise SystemExit(f"unknown argument {arg!r}")
    i += 1
  try:
    return config_lib.apply_overrides(cfg, overrides)
  except KeyError as e:
    raise SystemExit(f"unknown config field: {e}") from e


if __name__ == "__main__":
  from agents_tpu_torch.utils import config as config_lib

  cfg = parse_args(sys.argv[1:], Config())
  os.makedirs(cfg.root_dir, exist_ok=True)
  config_lib.save(cfg, os.path.join(cfg.root_dir, "config.json"))
  final, eval_return = train_eval(cfg)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed}))
