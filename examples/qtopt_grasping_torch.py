"""QT-Opt's grasping Q-function with the PyTorch port (`agents_tpu_torch`).

Kalashnikov et al. 2018 (arXiv:1806.10293): the image-and-action conv
critic of ``agents_tpu_torch/networks/qtopt_networks.py`` over 472 x 472
x 3 uint8 images and the gripper's state, trained by `QtOptAgent` with
the cross-entropy between sigmoid(logit) and the TD target, clipped
double Q over two lagged critics at the action CEM finds on the target
critic, gamma 0.9; CEM of 64 samples, 6 elites and 2 iterations acts and
forms every TD target, running each image through the critic's torso
once. The action is QT-Opt's 8 floats (a 3-D displacement, the sine and
cosine of a rotation, a one-hot of close, open and terminate), sampled as
a continuous and a one-hot part (`GaussianOneHotSampler` under a
`ConcatenatedSampler`). The env is `SyntheticGrasp` on the card, B=32
rows of at most 20 steps; a uniform frame ring of 2,000 slots a row
(42.77 GB of images), one collect step and one train step on 32
transitions an iteration (`FusedTrainLoop`), Adam(1e-4), epsilon 0.1, a
hard target update every 50 steps and the lagged critics every 5, 256
initial collect steps, seed 0.

  --smoke       a short run at a small width (64 x 64 frames, narrow
                convs, B=8, ring 64, 20 iterations), on the card or with
                --device cpu.

Like ``examples/dqn_cartpole_torch.py`` it writes ``train.jsonl`` and
``config.json`` under `root_dir` (``runs/qtopt_grasping_torch`` unless
set), evaluates greedily over `num_eval_episodes` and prints a final JSON
line.

Usage:
  python examples/qtopt_grasping_torch.py [--device cuda|cpu] [--smoke]
      [--cfg.<field>=<value> ...]
"""
import dataclasses
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from agents_tpu_torch.networks import qtopt_networks as grasp  # noqa: E402
from examples.dqn_cartpole_torch import parse_args, train_eval  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "qtopt_grasping_torch")
  image_size: int = 472
  horizon: int = 20
  step_size: float = 0.1
  grasp_radius: float = 0.25
  env_batch_size: int = 32
  num_iterations: int = 10000
  initial_collect_steps: int = 256
  replay_capacity: int = 2000          # per env row
  sample_batch_size: int = 32
  torso_conv_layer_params: tuple = grasp.GRASP_TORSO
  torso_padding: tuple = grasp.GRASP_TORSO_PADDING
  torso_max_pools: tuple = grasp.GRASP_TORSO_POOLS   # (after, kernel, stride)
  merge_fc_layer_params: tuple = grasp.GRASP_MERGE
  head_conv_layer_params: tuple = grasp.GRASP_HEAD
  head_max_pools: tuple = grasp.GRASP_HEAD_POOLS
  head_fc_layer_params: tuple = grasp.GRASP_HEAD_FC
  cem_num_samples: int = 64
  cem_num_elites: int = 6
  cem_num_iterations: int = 2
  learning_rate: float = 1e-4
  epsilon_greedy: float = 0.1
  gamma: float = 0.9
  target_update_tau: float = 1.0
  target_update_period: int = 50
  delayed_target_update_period: int = 5
  return_buffer: int = 20              # episodes in the AverageReturn deque
  log_interval: int = 1000
  num_eval_episodes: int = 10
  seed: int = 0
  device: str = "cuda"


SMOKE = dict(image_size=64, env_batch_size=8, replay_capacity=64,
             sample_batch_size=8, initial_collect_steps=8,
             torso_conv_layer_params=((8, 6, 2), (8, 5, 1)),
             torso_padding=("VALID", "SAME"), torso_max_pools=((0, 3, 3),),
             merge_fc_layer_params=(16, 8),
             head_conv_layer_params=((8, 3, 1), (8, 3, 1)),
             head_max_pools=((0, 2, 2),), head_fc_layer_params=(16,),
             cem_num_samples=16, cem_num_elites=3, num_iterations=20,
             log_interval=10, num_eval_episodes=4)

# The continuous part (displacement, rotation) and the one-hot command of
# QT-Opt's action, as CEM samples them; packed in this (sorted) order.
CONTINUOUS, COMMANDS = 5, 3


def sampler_spec():
  import numpy as np

  from agents_tpu_torch.specs import array_spec
  return {"continuous": array_spec.BoundedArraySpec(
              (CONTINUOUS,), np.float32, -1.0, 1.0, "continuous"),
          "one_hot": array_spec.BoundedArraySpec(
              (COMMANDS,), np.int32, 0, 1, "one_hot")}


def build_loop(cfg: Config):
  """The env, agent, replay and fused loop of `cfg`."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.qtopt import QtOptAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import SyntheticGrasp
  from agents_tpu_torch.policies.cem_samplers import (ConcatenatedSampler,
                                                      GaussianOneHotSampler)
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import common
  from agents_tpu_torch.utils.device import resolve_device

  device = resolve_device(cfg.device)
  env = BatchedTorchEnv(SyntheticGrasp(cfg.image_size, cfg.horizon,
                                       cfg.step_size, cfg.grasp_radius),
                        cfg.env_batch_size, device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(cfg.seed)
  critic = grasp.make_grasp_q_network(
      (tss.observation, asp), cfg.torso_conv_layer_params, cfg.torso_padding,
      cfg.torso_max_pools, cfg.merge_fc_layer_params,
      cfg.head_conv_layer_params, cfg.head_max_pools,
      cfg.head_fc_layer_params, device=device, generator=generator)
  lr = cfg.learning_rate
  agent = QtOptAgent(
      tss, asp, critic, lambda p: torch.optim.Adam(p, lr=lr),
      epsilon_greedy=cfg.epsilon_greedy,
      cem_num_samples=cfg.cem_num_samples, cem_num_elites=cfg.cem_num_elites,
      cem_num_iterations=cfg.cem_num_iterations,
      delayed_target_update_period=cfg.delayed_target_update_period,
      td_errors_loss_fn=common.element_wise_sigmoid_cross_entropy,
      gamma=cfg.gamma, target_update_tau=cfg.target_update_tau,
      target_update_period=cfg.target_update_period,
      cem_sampler=ConcatenatedSampler(GaussianOneHotSampler(sampler_spec())),
      q_logits=True, device=device)
  replay = UniformReplay(tj.trajectory_spec(tss, asp),
                         batch_size=cfg.env_batch_size,
                         max_length=cfg.replay_capacity, device=device)
  return FusedTrainLoop(
      env, agent, replay,
      metrics=metrics.standard_collect_metrics(cfg.return_buffer),
      sample_batch_size=cfg.sample_batch_size, device=device)


if __name__ == "__main__":
  cfg = parse_args(sys.argv[1:], Config(), smoke=SMOKE)
  os.makedirs(cfg.root_dir, exist_ok=True)
  with open(os.path.join(cfg.root_dir, "config.json"), "w") as f:
    json.dump(dataclasses.asdict(cfg), f, indent=2)
  final, eval_return = train_eval(cfg, build=build_loop)
  print(json.dumps({"final_average_return": final,
                    "eval_average_return": eval_return,
                    "seed": cfg.seed}))
