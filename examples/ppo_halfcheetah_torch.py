"""PPO-clip on MuJoCo HalfCheetah with the PyTorch port (`agents_tpu_torch`).

Port of ``examples/ppo_halfcheetah.py`` (the schulman17 operating point)
with the same `Config` defaults: one HalfCheetah env stepped on the host,
2,049-step rollouts (2,048 training frames), 10 epochs x 32 minibatches
of 64, tanh (64, 64) actor and value networks, a `NormalProjection` head
whose state-independent std starts at 0.35, Adam(3e-4, eps 1e-5) decayed
linearly to 0 over the run, gradient clipping 0.5. The loop is
`HostOnPolicyTrainLoop`; greedy eval goes through `JittedPyPolicy` and
`compute` every `eval_every_iterations` iterations and at the end. Unlike
the JAX example it checkpoints the agent, its draw source, the iteration
and the metric states every `checkpoint_interval_iterations` through the
port's `Checkpointer`, and with `resume` continues from the newest
checkpoint under `root_dir` (the env restarts from reset). It writes
``train.jsonl`` (appended across resumed runs) and ``config.json`` under
`root_dir` (``runs/ppo_halfcheetah_torch`` unless set) and prints a
final JSON line.

It needs gymnasium and MuJoCo (`--smoke` runs a short config, e.g. on the
CPU with ``--device cpu``).

Usage:
  python examples/ppo_halfcheetah_torch.py [--device cuda|cpu] [--smoke]
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
  root_dir: str = os.path.join(_REPO, "runs", "ppo_halfcheetah_torch")
  env_name: str = "HalfCheetah-v5"
  env_batch_size: int = 1
  rollout_length: int = 2049         # trains on T-1 = 2048 frames
  num_iterations: int = 489          # x 2048 ~= 1M transitions
  num_epochs: int = 10
  num_minibatches: int = 32          # 2048 / 32 = minibatch 64
  learning_rate: float = 3e-4
  importance_ratio_clipping: float = 0.2
  lambda_value: float = 0.95
  discount_factor: float = 0.99
  entropy_regularization: float = 0.0
  gradient_clipping: float = 0.5
  actor_fc_layers: tuple = (64, 64)
  value_fc_layers: tuple = (64, 64)
  log_interval: int = 10
  num_eval_episodes: int = 30
  num_eval_envs: int = 10
  eval_every_iterations: int = 120
  checkpoint_interval_iterations: int = 50
  checkpoint_max_to_keep: int = 2
  resume: bool = True
  seed: int = 0
  device: str = "cuda"


SMOKE = dict(rollout_length=65, num_iterations=4, num_epochs=2,
             num_minibatches=4, log_interval=2, num_eval_episodes=1,
             num_eval_envs=1, eval_every_iterations=0,
             checkpoint_interval_iterations=2)


def build_loop(cfg: Config, make_env=None):
  """(the host on-policy loop, the eval env) of `cfg`; the device is
  checked before any env is built. `make_env()` builds one host env
  (``suite_gym.load(cfg.env_name)`` unless given)."""
  import functools

  import torch

  from agents_tpu_torch.agents.ppo import PPOClipAgent
  from agents_tpu_torch.environments import suite_gym
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.networks import (NormalProjection,
                                         make_actor_distribution_network,
                                         make_value_network)
  from agents_tpu_torch.train import HostOnPolicyTrainLoop
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  make_env = make_env or (lambda: suite_gym.load(cfg.env_name))
  env = BatchedPyEnvironment([make_env() for _ in range(cfg.env_batch_size)])
  env.seed(cfg.seed)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)
  projection = functools.partial(
      NormalProjection,
      std_bias_initializer_value=math.log(math.exp(0.35) - 1.0))
  actor = make_actor_distribution_network(
      tss.observation, asp, fc_layer_params=cfg.actor_fc_layers,
      activation=torch.tanh, continuous_projection=projection,
      device=device, generator=generator)
  value = make_value_network(tss.observation,
                             fc_layer_params=cfg.value_fc_layers,
                             activation=torch.tanh, device=device,
                             generator=generator)
  steps = cfg.num_iterations * cfg.num_epochs * cfg.num_minibatches
  lr = cfg.learning_rate
  agent = PPOClipAgent(
      tss, asp, lambda p: torch.optim.Adam(p, lr=lr, eps=1e-5), actor, value,
      importance_ratio_clipping=cfg.importance_ratio_clipping,
      discount_factor=cfg.discount_factor, lambda_value=cfg.lambda_value,
      num_epochs=cfg.num_epochs, num_minibatches=cfg.num_minibatches,
      entropy_regularization=cfg.entropy_regularization,
      gradient_clipping=cfg.gradient_clipping or None,
      lr_schedule=lambda count: 1.0 - min(count, steps) / steps,
      device=device)
  loop = HostOnPolicyTrainLoop(
      env, agent, rollout_length=cfg.rollout_length,
      py_metrics=[py_metrics.AverageReturnMetric(20),
                  py_metrics.EnvironmentSteps()],
      device=device)
  eval_env = BatchedPyEnvironment(
      [make_env() for _ in range(cfg.num_eval_envs)])
  eval_env.seed(cfg.seed + 1000)
  return loop, eval_env


def checkpoint_state(loop, agent_state, draws, iteration: int):
  from agents_tpu_torch.metrics import py_metrics
  return {"agent_state": agent_state, "draws": draws,
          "iteration": iteration,
          "metrics": py_metrics.fixed_shape_states(loop.py_metrics)}


def train_eval(cfg: Config):
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.train import Checkpointer
  from agents_tpu_torch.utils.draws import Draws

  loop, eval_env = build_loop(cfg)
  agent = loop.agent
  eval_policy = JittedPyPolicy(agent.policy, seed=cfg.seed + 101,
                               device=loop.device)

  def run_eval(agent_state) -> float:
    eval_policy.update_params(agent.policy_params(agent_state))
    res = metric_utils.compute(
        [py_metrics.AverageReturnMetric(cfg.num_eval_episodes)],
        eval_env, eval_policy, num_episodes=cfg.num_eval_episodes)
    return float(res["AverageReturn"])

  agent_state, time_step = loop.init(cfg.seed)
  draws = Draws(cfg.seed + 1, loop.device)
  start = 0
  ckpt = None
  if cfg.checkpoint_interval_iterations:
    ckpt = Checkpointer(os.path.join(cfg.root_dir, "checkpoints"),
                        max_to_keep=cfg.checkpoint_max_to_keep)
    if cfg.resume and ckpt.latest_step() is not None:
      st = ckpt.restore(checkpoint_state(loop, agent_state, draws, 0))
      agent_state, draws, start = (st["agent_state"], st["draws"],
                                   st["iteration"])
      py_metrics.load_fixed_shape_states(loop.py_metrics, st["metrics"])
      print(f"resumed from iteration {start}", flush=True)

  os.makedirs(cfg.root_dir, exist_ok=True)
  log = open(os.path.join(cfg.root_dir, "train.jsonl"), "a")

  def write(step, **values):
    for key, value in values.items():
      log.write(json.dumps({"step": step, key: value, "t": time.time()})
                + "\n")
    log.flush()

  t0, ret, steps0 = time.time(), 0.0, loop.metric_results()[
      "EnvironmentSteps"]
  try:
    for it in range(start + 1, cfg.num_iterations + 1):
      agent_state, time_step, draws, info = loop.run_iteration(
          agent_state, time_step, draws)
      results = loop.metric_results()
      if it % cfg.log_interval == 0:
        ret, steps = results["AverageReturn"], results["EnvironmentSteps"]
        print(f"iter {it}: env_steps={steps} AverageReturn={ret:.0f} "
              f"loss={float(info.loss):.3f} "
              f"({(steps - steps0) / (time.time() - t0):.0f} env-steps/s)",
              flush=True)
        write(steps, AverageReturn=ret, loss=float(info.loss))
      if cfg.eval_every_iterations and it % cfg.eval_every_iterations == 0:
        eval_ret = run_eval(agent_state)
        write(results["EnvironmentSteps"], EvalAverageReturn=eval_ret)
        print(f"iter {it}: EvalAverageReturn={eval_ret:.0f}", flush=True)
      if ckpt is not None and it % cfg.checkpoint_interval_iterations == 0:
        ckpt.save(it, checkpoint_state(loop, agent_state, draws, it))
    final_eval = run_eval(agent_state)
    steps = loop.metric_results()["EnvironmentSteps"]
    write(steps, EvalAverageReturn=final_eval)
  finally:
    log.close()
    loop.env.close()
    eval_env.close()
  return {"collect_return": ret, "eval_average_return": final_eval,
          "env_steps": int(steps), "iterations": cfg.num_iterations,
          "resumed_from": start, "wall_s": time.time() - t0}


if __name__ == "__main__":
  cfg = parse_args(sys.argv[1:], Config(), smoke=SMOKE)
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  out = train_eval(cfg)
  print(json.dumps(out))
