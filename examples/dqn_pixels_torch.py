"""Pixel DQN with the PyTorch port (`agents_tpu_torch`): the mnih15 conv
Q-network on SyntheticPixels, or a small conv net on Catch; DQN or C51.

The default `Config` is the construction of ``bench.py:conv_bench``
(:202-221): B=128 env rows of 84x84x4 uint8 frames, ring 2048 per row
(7,398,752,256 bytes of uint8 observations on the card), sample 256,
convs (32, 8, 4), (64, 4, 2), (64, 3, 1) then fc 512, bfloat16 compute
with float32 params, frames scaled by 1/255, Adam(2.5e-4, eps 1.5e-4),
epsilon 0.05, gamma 0.99, a hard target update every 500 steps, Huber
loss, 64 initial collect steps, seed 0. On a card Adam is `capturable`,
so the agent replays each train step as one CUDA graph
(``agents_tpu_torch/agents/dqn/dqn_agent.py``).

  --env=catch   the config of ``tests/test_catch_conv_e2e.py:51-65``:
                Catch 8x5, B=64, conv (8, 3, 1), fc 64, float32, Adam 1e-3,
                epsilon 0.1, target update every 50, squared loss, ring 256,
                sample 128, 32 initial collect steps, a 100-episode return
                deque, 2,400 iterations.
  --agent=c51   C51 (51 atoms on [-10, 10]) on the same torso.
  --agent=r2d2  R2D2 (Kapturowski et al. 2019, Table 1;
                ``agents_tpu_torch/agents/dqn/r2d2_agent.py``): the conv
                torso unpadded ("VALID", 84 -> 20 -> 9 -> 7) and fc 512,
                with the one-hot previous action and previous reward into
                an LSTM of 512, then dueling streams of 512; one 84x84x1
                frame per observation, 18 actions, float32; sequences of
                40 burn-in + 80 trained frames starting every 40 ring
                slots, sampled by priority (exponent 0.9, IS exponent
                0.6, priority eta 0.9); 5-step double-Q targets under
                value rescaling (eps 1e-3), gamma 0.997, the squared TD
                error; Adam(1e-4, eps 1e-3), sample 64, a hard target
                update every 2,500 steps, 128 initial collect steps. The
                ring stores each frame's carry (c, h) beside it (4,104
                more bytes a frame at LSTM 512).
  --smoke       a short run at a small width (B=16, ring 128, sample 32,
                200 iterations), on the card or with --device cpu.

Like ``examples/dqn_cartpole_torch.py`` it writes ``train.jsonl`` and
``config.json`` under `root_dir` (``runs/dqn_pixels_torch`` unless set),
evaluates greedily over `num_eval_episodes` and prints a final JSON line.

Usage:
  python examples/dqn_pixels_torch.py [--env=pixels|catch]
      [--agent=dqn|c51|r2d2]
      [--device cuda|cpu] [--smoke] [--cfg.<field>=<value> ...]
"""
import dataclasses
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from examples.dqn_cartpole_torch import parse_args, train_eval  # noqa: E402

MNIH15 = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "dqn_pixels_torch")
  env: str = "pixels"                  # "pixels" (SyntheticPixels), "catch"
  agent: str = "dqn"                   # "dqn", "c51" or "r2d2"
  pixels_size: int = 84
  pixels_frames: int = 4
  pixels_actions: int = 6
  pixels_horizon: int = 500
  catch_rows: int = 8
  catch_columns: int = 5
  env_batch_size: int = 128
  num_iterations: int = 10000
  initial_collect_steps: int = 64
  replay_capacity: int = 2048          # per env row
  sample_batch_size: int = 256
  conv_layer_params: tuple = MNIH15
  fc_layer_params: tuple = (512,)
  dtype: str = "bfloat16"              # compute dtype; params stay float32
  scale_pixels: bool = True            # preprocessing x.to(dtype) / 255
  learning_rate: float = 2.5e-4
  adam_eps: float = 1.5e-4
  epsilon_greedy: float = 0.05
  gamma: float = 0.99
  target_update_tau: float = 1.0
  target_update_period: int = 500
  td_loss: str = "huber"               # "huber" or "squared" (DQN only)
  num_atoms: int = 51                  # C51 only
  min_q_value: float = -10.0
  max_q_value: float = 10.0
  lstm_size: int = 512                 # R2D2 only, as the fields below
  dueling_fc_layer_params: tuple = (512,)
  burn_in: int = 40
  train_sequence_length: int = 120     # burn-in and trained frames
  n_step_update: int = 5
  sequence_stride: int = 40            # ring slots between sequence starts
  return_buffer: int = 20              # episodes in the AverageReturn deque
  log_interval: int = 1000
  num_eval_episodes: int = 30
  seed: int = 0
  device: str = "cuda"


CATCH = dict(
    env="catch", env_batch_size=64, replay_capacity=256,
    sample_batch_size=128, initial_collect_steps=32,
    conv_layer_params=((8, 3, 1),), fc_layer_params=(64,), dtype="float32",
    scale_pixels=False, learning_rate=1e-3, adam_eps=1e-8,
    epsilon_greedy=0.1, target_update_period=50, td_loss="squared",
    return_buffer=100, num_iterations=2400, log_interval=400)

SMOKE = dict(env_batch_size=16, replay_capacity=128, sample_batch_size=32,
             initial_collect_steps=16, num_iterations=200, log_interval=100,
             num_eval_episodes=4)

# R2D2's priority and IS-weight exponents (Kapturowski et al. 2019, Table 1).
R2D2_PRIORITY_EXPONENT, R2D2_IMPORTANCE_EXPONENT = 0.9, 0.6

R2D2 = dict(
    agent="r2d2", pixels_frames=1, pixels_actions=18,
    dtype="float32", learning_rate=1e-4, adam_eps=1e-3, gamma=0.997,
    sample_batch_size=64, target_update_period=2500,
    initial_collect_steps=128)

R2D2_SMOKE = dict(SMOKE, replay_capacity=256, sample_batch_size=8,
                  initial_collect_steps=128, num_iterations=20,
                  log_interval=10)


def build_loop(cfg: Config):
  """The env, agent, replay and fused loop of `cfg`."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.categorical_dqn import CategoricalDqnAgent
  from agents_tpu_torch.agents.dqn import DqnAgent, R2d2Agent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import Catch, SyntheticPixels
  from agents_tpu_torch.networks import (make_categorical_q_network,
                                         make_q_network,
                                         make_recurrent_dueling_q_network)
  from agents_tpu_torch.replay_buffers import (PrioritizedReplay,
                                               UniformReplay)
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import common
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  if cfg.env == "pixels":
    pyenv = SyntheticPixels(cfg.pixels_size, cfg.pixels_frames,
                            cfg.pixels_actions, cfg.pixels_horizon)
  elif cfg.env == "catch":
    pyenv = Catch(cfg.catch_rows, cfg.catch_columns)
  else:
    raise ValueError(f"unknown env {cfg.env!r}")
  env = BatchedTorchEnv(pyenv, cfg.env_batch_size, device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  dtype = getattr(torch, cfg.dtype)
  preprocessing = (lambda x: x.to(dtype) / 255.0) if cfg.scale_pixels \
      else None
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)
  net_kwargs = dict(conv_layer_params=cfg.conv_layer_params,
                    fc_layer_params=cfg.fc_layer_params, dtype=dtype,
                    preprocessing=preprocessing, device=device,
                    generator=generator)
  lr, eps = cfg.learning_rate, cfg.adam_eps
  # On a card, Adam keeps its step count there, so `DqnAgent.train` can
  # replay the whole train step as one CUDA graph.
  capturable = device.type == "cuda"
  optimizer_fn = lambda p: torch.optim.Adam(  # noqa: E731
      p, lr=lr, eps=eps, capturable=capturable)
  agent_kwargs = dict(epsilon_greedy=cfg.epsilon_greedy, gamma=cfg.gamma,
                      target_update_tau=cfg.target_update_tau,
                      target_update_period=cfg.target_update_period,
                      device=device)
  if cfg.agent == "c51":
    qnet = make_categorical_q_network(tss.observation, asp,
                                      num_atoms=cfg.num_atoms, **net_kwargs)
    agent = CategoricalDqnAgent(tss, asp, qnet, optimizer_fn,
                                min_q_value=cfg.min_q_value,
                                max_q_value=cfg.max_q_value, **agent_kwargs)
  elif cfg.agent == "dqn":
    qnet = make_q_network(tss.observation, asp, **net_kwargs)
    loss_fn = {"huber": common.element_wise_huber_loss,
               "squared": common.element_wise_squared_loss}[cfg.td_loss]
    agent = DqnAgent(tss, asp, qnet, optimizer_fn, td_errors_loss_fn=loss_fn,
                     **agent_kwargs)
  elif cfg.agent == "r2d2":
    qnet = make_recurrent_dueling_q_network(
        tss.observation, asp, lstm_size=cfg.lstm_size,
        dueling_fc_layer_params=cfg.dueling_fc_layer_params, **net_kwargs)
    agent = R2d2Agent(tss, asp, qnet, optimizer_fn, burn_in=cfg.burn_in,
                      train_sequence_length=cfg.train_sequence_length,
                      n_step_update=cfg.n_step_update, **agent_kwargs)
  else:
    raise ValueError(f"unknown agent {cfg.agent!r}")
  loop_kwargs = {}
  if cfg.agent == "r2d2":
    # The ring stores each frame's policy info (the carry) beside it.
    replay = PrioritizedReplay(
        tj.trajectory_spec(tss, asp, agent.collect_policy.info_spec),
        batch_size=cfg.env_batch_size, max_length=cfg.replay_capacity,
        alpha=R2D2_PRIORITY_EXPONENT, sequence_stride=cfg.sequence_stride,
        device=device)
    loop_kwargs["per_beta"] = R2D2_IMPORTANCE_EXPONENT
  else:
    replay = UniformReplay(tj.trajectory_spec(tss, asp),
                           batch_size=cfg.env_batch_size,
                           max_length=cfg.replay_capacity, device=device)
  return FusedTrainLoop(
      env, agent, replay,
      metrics=metrics.standard_collect_metrics(cfg.return_buffer),
      sample_batch_size=cfg.sample_batch_size, device=device, **loop_kwargs)


def parse_pixel_args(argv) -> Config:
  """--env=catch and --agent=c51 or r2d2 (R2D2's fields) first, then
  `parse_args`'s --smoke, --device and --cfg.<field>=<value>."""
  cfg, rest = Config(), []
  for arg in argv:
    if arg.startswith("--env="):
      env = arg.split("=", 1)[1]
      if env not in ("pixels", "catch"):
        raise SystemExit(f"unknown env {env!r}")
      cfg = dataclasses.replace(cfg, **CATCH) if env == "catch" else cfg
    elif arg == "--agent=r2d2":
      cfg = dataclasses.replace(cfg, **R2D2)
    elif arg.startswith("--agent="):
      cfg = dataclasses.replace(cfg, agent=arg.split("=", 1)[1])
    else:
      rest.append(arg)
  smoke = R2D2_SMOKE if cfg.agent == "r2d2" else SMOKE
  return parse_args(rest, cfg, smoke=smoke)


if __name__ == "__main__":
  cfg = parse_pixel_args(sys.argv[1:])
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  final, eval_return = train_eval(cfg, build=build_loop)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed}))
