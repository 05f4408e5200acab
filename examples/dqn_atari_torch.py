"""DQN on Atari (the Mnih et al. 2015 configuration) with the PyTorch port.

The port's twin of ``examples/dqn_atari.py``, with the same `Config` (plus
`device`): `env_batch_size` ALE instances on the host, each behind the
DQN-paper preprocessing of `suites.load_atari` (frame-skip 4 with
max-pooling, 84x84 grayscale, 4 frames stacked as channels: observations
[84, 84, 4] uint8), feeding the asynchronous collector-trainer loop; the
mnih15 conv Q-network (frames scaled by 1/255, fc 512, float32), Adam
2.5e-4 with eps 0.01, gamma 0.99, the Huber loss, a hard target update
every 2,500 train steps, epsilon decayed polynomially from 1.0 to 0.1 over
250,000 train steps, and a device replay of `replay_capacity_frames` uint8
frames (1,000,000: 125,000 per row at B=8, 28.2 GB of observations on the
card). The trainer takes 8 steps of 32 samples per call at 1 train step
per 4 env steps once the replay holds `initial_collect_ticks` x B frames.

It writes ``train.jsonl`` (AverageReturn every `progress_every_ticks`
ticks) under `root_dir` (``runs/dqn_atari_torch`` unless set) and, at
the end, the greedy policy through `PolicySaver` under
``root_dir/policies/greedy``. The network's 1/255 preprocessing is a
lambda, so the manifest holds no policy config: the artifact acts through
its `torch.export` program (its ``loader.py``), or through
`load_policy(dir, policy=...)` with the policy object.

It needs ale-py (``pip install ale-py gymnasium[atari]``) and raises the
JAX example's ImportError without it. `train_eval(cfg, make_env=...)`
takes another host env factory (the tests and the card's smoke run use
random environments with the Atari specs).

Usage:
  python examples/dqn_atari_torch.py [--cfg.game=PongNoFrameskip-v4]
      [--device cuda|cpu] [--smoke] [--cfg.<field>=<value> ...]
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
  root_dir: str = os.path.join(_REPO, "runs", "dqn_atari_torch")
  game: str = "PongNoFrameskip-v4"
  env_batch_size: int = 8               # parallel ALE instances
  total_env_steps: int = 12_500_000     # 50M frames / frame-skip 4
  initial_collect_ticks: int = 2500     # x batch ~= 20k random frames
  replay_capacity_frames: int = 1_000_000
  sample_batch_size: int = 32
  train_steps_per_call: int = 8
  utd_ratio: float = 0.25               # 1 train step / 4 collect steps
  conv_layer_params: tuple = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
  fc_layer_params: tuple = (512,)
  learning_rate: float = 2.5e-4
  adam_epsilon: float = 0.01
  epsilon_greedy_final: float = 0.1
  epsilon_decay_steps: int = 250_000
  gamma: float = 0.99
  target_update_period: int = 2500
  progress_every_ticks: int = 2000
  device: str = "cuda"


# The JAX example's --smoke.
SMOKE = dict(total_env_steps=4000, initial_collect_ticks=20,
             progress_every_ticks=100)

ATARI_MISSING = ("dqn_atari requires ale-py (pip install ale-py "
                 "gymnasium[atari]); it is not bundled in this image.")


def atari_specs(num_actions: int = 6):
  """(observation, action) specs of a `suites.load_atari` env with
  `num_actions` actions (Pong's 6 by default): [84, 84, 4] uint8 frames in
  [0, 255], a scalar int64 action."""
  import numpy as np

  from agents_tpu_torch.specs import array_spec

  return (array_spec.BoundedArraySpec((84, 84, 4), np.uint8, 0, 255,
                                      "observation"),
          array_spec.BoundedArraySpec((), np.int64, 0, num_actions - 1,
                                      "action"))


def epsilon_fn(cfg: Config):
  """The collect epsilon at a train step: 1.0 decayed linearly to
  `epsilon_greedy_final` over `epsilon_decay_steps` train steps, then
  held (the JAX example's :78-81)."""
  def epsilon(train_step: int) -> float:
    frac = min(train_step / cfg.epsilon_decay_steps, 1.0)
    return 1.0 + frac * (cfg.epsilon_greedy_final - 1.0)
  return epsilon


def build_agent(cfg: Config, tss, asp, device, seed: int = 0):
  """The conv Q-network, `DqnAgent` and device replay of `cfg` (networks
  drawn from `seed`)."""
  import torch

  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import common

  generator = torch.Generator(device=device)
  generator.manual_seed(seed)
  qnet = make_q_network(
      tss.observation, asp, conv_layer_params=cfg.conv_layer_params,
      fc_layer_params=cfg.fc_layer_params,
      preprocessing=lambda x: x.to(torch.float32) / 255.0, device=device,
      generator=generator)
  agent = DqnAgent(
      tss, asp, qnet,
      lambda params: torch.optim.Adam(params, lr=cfg.learning_rate,
                                      eps=cfg.adam_epsilon),
      epsilon_greedy=epsilon_fn(cfg), gamma=cfg.gamma,
      target_update_tau=1.0, target_update_period=cfg.target_update_period,
      td_errors_loss_fn=common.element_wise_huber_loss, device=device)
  replay = UniformReplay(
      tj.trajectory_spec(tss, asp), batch_size=cfg.env_batch_size,
      max_length=cfg.replay_capacity_frames // cfg.env_batch_size,
      device=device)
  return agent, replay


def build_loop(cfg: Config, make_env=None):
  """The async loop of `cfg` over `env_batch_size` envs from `make_env()`
  (``suites.load_atari(cfg.game)`` unless given); the device is checked
  before any env is built."""
  from agents_tpu_torch.environments import suites
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.train import AsyncHostDeviceTrainLoop
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  if make_env is None:
    if not suites.is_atari_available():
      raise ImportError(ATARI_MISSING)
    make_env = lambda: suites.load_atari(cfg.game)  # noqa: E731
  env = BatchedPyEnvironment(
      [make_env() for _ in range(cfg.env_batch_size)])
  agent, replay = build_agent(cfg, env.time_step_spec(), env.action_spec(),
                              device)
  return AsyncHostDeviceTrainLoop(
      env, agent, replay, sample_batch_size=cfg.sample_batch_size,
      train_steps_per_call=cfg.train_steps_per_call,
      utd_ratio=cfg.utd_ratio,
      min_replay_frames=cfg.initial_collect_ticks * cfg.env_batch_size,
      py_metrics=[py_metrics.AverageReturnMetric(20),
                  py_metrics.EnvironmentSteps(),
                  py_metrics.NumberOfEpisodes()],
      device=device)


def train_eval(cfg: Config, make_env=None):
  """Train, print and log progress, save the greedy policy; returns the
  loop's `run` dict with ``policy_dir`` added."""
  from agents_tpu_torch.policies.policy_saver import PolicySaver
  from agents_tpu_torch.train import JsonlSummaryWriter

  loop = build_loop(cfg, make_env)
  agent = loop.agent
  writer = JsonlSummaryWriter(os.path.join(cfg.root_dir, "train.jsonl"))
  t0 = time.time()

  def progress(l):
    ret = l.py_metrics[0].result()
    sps = l._env_steps / (time.time() - t0)
    print(f"env_steps={l._env_steps} train_steps={l._train_steps} "
          f"AverageReturn={ret:.1f} ({sps:.0f} env-steps/s)", flush=True)
    writer.scalar("AverageReturn", ret, l._env_steps)

  try:
    out = loop.run(
        total_env_batch_steps=cfg.total_env_steps // cfg.env_batch_size,
        initial_random_steps=cfg.initial_collect_ticks,
        progress_fn=progress, progress_every=cfg.progress_every_ticks)
  finally:
    writer.close()
    loop.env.close()

  out["policy_dir"] = os.path.join(cfg.root_dir, "policies", "greedy")
  PolicySaver(agent.policy, train_step=out["train_steps"]).save(
      out["policy_dir"], agent.policy_params(out["agent_state"]))
  return out


def main(argv, make_env=None):
  """``--smoke``, ``--device DEV`` and ``--cfg.<field>=<value>``; returns
  `train_eval`'s dict."""
  cfg = parse_args(argv[1:], Config(), smoke=SMOKE)
  os.makedirs(cfg.root_dir, exist_ok=True)
  out = train_eval(cfg, make_env)
  print(json.dumps({
      "env_steps": out["env_steps"], "train_steps": out["train_steps"],
      "wall_s": round(out["wall_s"], 1),
      "final_average_return": out["metrics"]["AverageReturn"],
      "trainer_drained": out["trainer_drained"],
      "policy_dir": out["policy_dir"]}), flush=True)
  return out


if __name__ == "__main__":
  main(sys.argv)
