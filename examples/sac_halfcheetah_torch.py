"""SAC on MuJoCo HalfCheetah with the PyTorch port (`agents_tpu_torch`).

Port of ``examples/sac_halfcheetah.py`` (the haarnoja18 config) with the
same `Config` defaults: host MuJoCo simulation (32 gymnasium envs on a
thread pool) feeding the device replay and learner through the
asynchronous collector-trainer loop, greedy eval every `eval_every_ticks`
ticks and at the end through `JittedPyPolicy` and `compute`, and a full
checkpoint (agent, optimizers, replay, draw sources, counters, metric
states) every `checkpoint_interval_ticks` ticks through the port's
`Checkpointer`; with `resume` a run restores the newest checkpoint under
`root_dir` and continues toward its target. At the end it saves the
greedy policy through the port's `PolicySaver` under
``root_dir/policies/greedy_policy`` (as the JAX example does at
:154-156; `policy_saver.load_policy` reloads it). It writes
``train.jsonl`` (appended across resumed runs) and ``config.json`` under
`root_dir` (``runs/sac_halfcheetah_torch`` unless set) and prints a final
JSON line.

It needs gymnasium and MuJoCo (`--smoke` runs a short, narrow config,
e.g. on the CPU with ``--device cpu``).

Usage:
  python examples/sac_halfcheetah_torch.py [--device cuda|cpu] [--smoke]
      [--cfg.<field>=<value> ...]
"""
import dataclasses
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from examples.dqn_cartpole_torch import parse_args  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "sac_halfcheetah_torch")
  env_name: str = "HalfCheetah-v5"
  env_batch_size: int = 32
  total_env_steps: int = 1_000_000
  initial_collect_ticks: int = 300      # x batch = random frames
  replay_capacity: int = 32768          # per row (~1M frames total)
  sample_batch_size: int = 256
  train_steps_per_call: int = 16
  utd_ratio: float = 0.5
  actor_fc_layers: tuple = (256, 256)
  critic_joint_fc_layers: tuple = (256, 256)
  actor_lr: float = 3e-4
  critic_lr: float = 3e-4
  alpha_lr: float = 3e-4
  gamma: float = 0.99
  target_update_tau: float = 0.005
  reward_scale_factor: float = 0.1
  progress_every_ticks: int = 1000
  num_eval_episodes: int = 30
  num_eval_envs: int = 10
  eval_every_ticks: int = 8000
  checkpoint_interval_ticks: int = 8000
  checkpoint_max_to_keep: int = 2
  resume: bool = True
  seed: int = 0
  device: str = "cuda"


SMOKE = dict(env_batch_size=2, total_env_steps=400, initial_collect_ticks=20,
             replay_capacity=512, sample_batch_size=32,
             train_steps_per_call=4, utd_ratio=1.0, actor_fc_layers=(32, 32),
             critic_joint_fc_layers=(32, 32), progress_every_ticks=50,
             num_eval_episodes=2, num_eval_envs=2, eval_every_ticks=0,
             checkpoint_interval_ticks=100)


def build_agent(cfg: Config, env, device):
  """The SAC agent and device replay of `cfg` for the batched host `env`."""
  import torch

  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_sac_actor_network)
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.trajectories import trajectory as tj

  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)

  def adam(lr):
    return lambda params: torch.optim.Adam(params, lr=lr)

  agent = SacAgent(
      tss, asp,
      make_critic_network(tss.observation, asp,
                          joint_fc_layer_params=cfg.critic_joint_fc_layers,
                          device=device, generator=generator),
      make_sac_actor_network(tss.observation, asp,
                             fc_layer_params=cfg.actor_fc_layers,
                             device=device, generator=generator),
      adam(cfg.actor_lr), adam(cfg.critic_lr), adam(cfg.alpha_lr),
      gamma=cfg.gamma, target_update_tau=cfg.target_update_tau,
      reward_scale_factor=cfg.reward_scale_factor, generator=generator,
      device=device)
  replay = UniformReplay(tj.trajectory_spec(tss, asp),
                         batch_size=cfg.env_batch_size,
                         max_length=cfg.replay_capacity, device=device)
  return agent, replay


def build_loop(cfg: Config, make_env=None):
  """(the async loop, the eval env) of `cfg`; the device is checked before
  any env is built. `make_env()` builds one host env (``suite_gym.load(
  cfg.env_name)`` unless given)."""
  from agents_tpu_torch.environments import suite_gym
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.train import AsyncHostDeviceTrainLoop
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  make_env = make_env or (lambda: suite_gym.load(cfg.env_name))
  env = BatchedPyEnvironment([make_env() for _ in range(cfg.env_batch_size)])
  env.seed(cfg.seed)
  agent, replay = build_agent(cfg, env, device)
  loop = AsyncHostDeviceTrainLoop(
      env, agent, replay, sample_batch_size=cfg.sample_batch_size,
      train_steps_per_call=cfg.train_steps_per_call,
      utd_ratio=cfg.utd_ratio,
      min_replay_frames=cfg.initial_collect_ticks * cfg.env_batch_size,
      py_metrics=[py_metrics.AverageReturnMetric(20),
                  py_metrics.EnvironmentSteps(),
                  py_metrics.NumberOfEpisodes()],
      device=device)
  eval_env = BatchedPyEnvironment(
      [make_env() for _ in range(cfg.num_eval_envs)])
  eval_env.seed(cfg.seed + 1000)
  return loop, eval_env


def train_eval(cfg: Config):
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.policies.policy_saver import PolicySaver
  from agents_tpu_torch.train import Checkpointer

  loop, eval_env = build_loop(cfg)
  agent = loop.agent
  eval_policy = JittedPyPolicy(agent.policy, seed=cfg.seed + 101,
                               device=loop.device)

  def run_eval(params) -> float:
    eval_policy.update_params(params)
    res = metric_utils.compute(
        [py_metrics.AverageReturnMetric(cfg.num_eval_episodes)],
        eval_env, eval_policy, num_episodes=cfg.num_eval_episodes)
    return float(res["AverageReturn"])

  os.makedirs(cfg.root_dir, exist_ok=True)
  log = open(os.path.join(cfg.root_dir, "train.jsonl"), "a")

  def write(step, **values):
    for key, value in values.items():
      log.write(json.dumps({"step": step, key: value, "t": time.time()})
                + "\n")
    log.flush()

  t0 = time.time()

  def progress(l):
    ret = l.py_metrics[0].result()
    sps = (l._env_steps - l._session_start_steps) / (time.time() - t0)
    line = (f"env_steps={l._env_steps} train_steps={l._train_steps} "
            f"AverageReturn={ret:.0f} ({sps:.0f} env-steps/s)")
    write(l._env_steps, AverageReturn=ret, train_steps=l._train_steps)
    # Eval keyed to the absolute tick count, so a resume keeps its cadence;
    # it acts from the trainer's last published parameters.
    ticks = l._env_steps // cfg.env_batch_size
    if cfg.eval_every_ticks and ticks % cfg.eval_every_ticks == 0:
      eval_ret = run_eval(l.published_params())
      write(l._env_steps, EvalAverageReturn=eval_ret)
      line += f" EvalAverageReturn={eval_ret:.0f}"
    print(line, flush=True)

  ckpt = None
  if cfg.checkpoint_interval_ticks:
    ckpt = Checkpointer(os.path.join(cfg.root_dir, "checkpoints"),
                        max_to_keep=cfg.checkpoint_max_to_keep)
  try:
    out = loop.run(
        total_env_batch_steps=cfg.total_env_steps // cfg.env_batch_size,
        seed=cfg.seed, initial_random_steps=cfg.initial_collect_ticks,
        progress_fn=progress, progress_every=cfg.progress_every_ticks,
        checkpointer=ckpt,
        checkpoint_interval_ticks=cfg.checkpoint_interval_ticks,
        resume=cfg.resume)
    final_eval = run_eval(agent.policy_params(out["agent_state"]))
    write(out["env_steps"], EvalAverageReturn=final_eval)
  finally:
    log.close()
    loop.env.close()
    eval_env.close()
  print(f"final greedy eval ({cfg.num_eval_episodes} episodes): "
        f"{final_eval:.0f}", flush=True)
  out["eval_average_return"] = final_eval

  out["policy_dir"] = os.path.join(cfg.root_dir, "policies", "greedy_policy")
  PolicySaver(agent.policy, train_step=out["train_steps"]).save(
      out["policy_dir"], agent.policy_params(out["agent_state"]))
  return out


if __name__ == "__main__":
  cfg = parse_args(sys.argv[1:], Config(), smoke=SMOKE)
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  out = train_eval(cfg)
  print(json.dumps({
      "env_steps": out["env_steps"], "train_steps": out["train_steps"],
      "wall_s": round(out["wall_s"], 1),
      "final_average_return": out["metrics"]["AverageReturn"],
      "eval_average_return": out["eval_average_return"],
      "trainer_drained": out["trainer_drained"], "seed": cfg.seed,
      "policy_dir": out["policy_dir"],
  }))
