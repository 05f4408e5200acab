"""DQN on CartPole with the PyTorch port (`agents_tpu_torch`).

The port's twin of ``examples/dqn_cartpole.py``: the same `Config`
(plus `device`), the same fused loop (one collect step and one train step
per iteration), greedy eval over `num_eval_episodes` at the end. It writes
``train.jsonl`` (loss, AverageReturn, steps_per_sec every `log_interval`
iterations, then EvalAverageReturn) and ``config.json`` under `root_dir`
(``runs/dqn_cartpole_torch`` in the repository unless set), and prints the
same final JSON line as the JAX example.

As the JAX example does through its `Learner` (learner.py:83-102), it
checkpoints the whole loop state under ``root_dir/train/checkpoints``
every `checkpoint_interval` iterations and once more at the end, and
starts from the newest checkpoint there when one exists, appending to
``train.jsonl``; a `checkpoint_interval` of 0 or less turns this off.

Usage:
  python examples/dqn_cartpole_torch.py [--device cuda|cpu] [--smoke]
      [--cfg.num_iterations=20000] [--cfg.<field>=<value> ...]
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
  """Train `build(cfg)`'s loop from its newest checkpoint under `root_dir`
  (or from the start), log to ``root_dir/train.jsonl``, evaluate
  greedily.

  Returns (last AverageReturn of the collect deque, greedy eval return).
  """
  from agents_tpu_torch.train import Checkpointer

  loop = build(cfg)
  state = loop.init(cfg.seed, initial_collect_steps=cfg.initial_collect_steps)
  os.makedirs(cfg.root_dir, exist_ok=True)
  log_path = os.path.join(cfg.root_dir, "train.jsonl")
  # The pixel and SAC examples' Configs, like their JAX twins', have no
  # checkpoint interval: they do not checkpoint.
  interval = getattr(cfg, "checkpoint_interval", 0)
  step, checkpointer = 0, None
  if interval > 0:
    checkpointer = Checkpointer(
        os.path.join(cfg.root_dir, "train", "checkpoints"))
    state = checkpointer.initialize_or_restore(state)
    step = checkpointer.latest_step() or 0

  def write(f, step, **values):
    for key, value in values.items():
      f.write(json.dumps({"step": step, key: value, "t": time.time()}) + "\n")
    f.flush()

  with open(log_path, "a" if step else "w") as f:
    start, t0 = step, time.time()
    saved = step - step % max(interval, 1)
    avg_return = float(loop.results(state)["AverageReturn"])
    while step < cfg.num_iterations:
      n = min(cfg.log_interval, cfg.num_iterations - step)
      state, losses = loop.run(state, n)
      step += n
      loss = float(losses[-1])
      avg_return = float(loop.results(state)["AverageReturn"])
      sps = (step - start) * cfg.env_batch_size / (time.time() - t0)
      print(f"iter {step}: loss={loss:.4f} AverageReturn={avg_return:.1f} "
            f"({sps:.0f} env-steps/s on {loop.device})", flush=True)
      write(f, step, loss=loss, AverageReturn=avg_return, steps_per_sec=sps)
      if checkpointer and step - saved >= interval:
        checkpointer.save(step, state)
        saved = step - step % interval
    if checkpointer:
      checkpointer.save(step, state)
    eval_out = loop.evaluate(state, cfg.seed + 101,
                             num_episodes=cfg.num_eval_episodes,
                             max_steps=2000)
    eval_return = float(eval_out["AverageReturn"])
    write(f, step, EvalAverageReturn=eval_return)
  print(f"final greedy eval ({cfg.num_eval_episodes} episodes): "
        f"{eval_return:.1f}", flush=True)
  return avg_return, eval_return


SMOKE = dict(num_iterations=2000, log_interval=500)


def parse_args(argv, cfg, smoke=SMOKE):
  """--smoke (the `smoke` fields), --device DEV and --cfg.<field>=<value>
  overrides of the dataclass `cfg`. A tuple of tuples is written
  ``32x8x4,64x4x2``."""
  fields = {f.name: f for f in dataclasses.fields(cfg)}
  argv = list(argv)
  if "--smoke" in argv:
    argv.remove("--smoke")
    cfg = dataclasses.replace(cfg, **smoke)
  i = 0
  while i < len(argv):
    arg = argv[i]
    if arg == "--device":
      cfg = dataclasses.replace(cfg, device=argv[i + 1])
      i += 2
      continue
    if arg.startswith("--device="):
      cfg = dataclasses.replace(cfg, device=arg.split("=", 1)[1])
    elif arg.startswith("--cfg.") and "=" in arg:
      name, value = arg[len("--cfg."):].split("=", 1)
      if name not in fields:
        raise SystemExit(f"unknown config field {name!r}; valid: "
                         f"{sorted(fields)}")
      current = getattr(cfg, name)
      if isinstance(current, tuple) and current and isinstance(
          current[0], tuple):
        value = tuple(tuple(int(v) for v in part.split("x"))
                      for part in value.split(",") if part)
      elif isinstance(current, tuple):
        value = tuple(int(v) for v in value.split(",") if v)
      elif isinstance(current, bool):
        value = value.lower() in ("1", "true", "yes")
      else:
        value = type(current)(value)
      cfg = dataclasses.replace(cfg, **{name: value})
    else:
      raise SystemExit(f"unknown argument {arg!r}")
    i += 1
  return cfg


if __name__ == "__main__":
  cfg = parse_args(sys.argv[1:], Config())
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  final, eval_return = train_eval(cfg)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed}))
