"""Plain reference of the fused DQN loop over Atari-shaped synthetic frames.

Written from the published descriptions, not from the program: the Nature
DQN (Mnih et al. 2015, "Methods: model architecture"; convolutions
(32, 8x8, 4), (64, 4x4, 2), (64, 3x3, 1), a dense layer of 512 and one
output per action, ReLU after each hidden layer, frames scaled by 1/255)
trained by Q-learning with a Huber TD loss against a target network and
Adam; and the synthetic frame task and the loop's order of work, which
the configuration file states:

  env      per row a hidden target action and a step count t; the frame
           is ``(r * 3 + c * 5 + f * 7 + 41 * target + 13 * t) % 251`` at
           row r, column c, frame f (uint8, H x W x F); playing the target
           gives reward 1; each step draws a new target ("pixels_step_
           target"); at t >= horizon the step is LAST with discount 0, and
           the next step of that row restarts it (t = 0, a target from
           "pixels_target", FIRST, reward 0, discount 1). A reset target
           is drawn at every step, used or not.
  collect  epsilon-greedy: the argmax of Q (the first of equal values), or
           where the "explore" uniform is below epsilon the "random_
           action" draw. One frame per row and step goes into the ring:
           (step type, observation, action, next step type, reward,
           discount) of the transition.
  sample   windows of 2 frames: start t0 = lo + "replay_t0" draw with
           lo = count - min(count, capacity), row from "replay_rows".
  train    TD target r + gamma * d * max_a Q_target(s', a); Huber loss
           (delta 1) against Q(s, a), zero where s is LAST, mean over the
           sample; Adam; every `target_update_period` steps the target
           takes tau * online + (1 - tau) * target.

Layout: convolutions pad as TensorFlow's SAME (ceil(size / stride)
outputs, the odd pixel at the end), and the last convolution's output is
flattened in (row, column, channel) order, the order of the dense
layer's input index. The draws are the ones the program was handed
(`common.Recorded`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import common

FIRST, MID, LAST = 0, 1, 2


def leaves(hp) -> List[tuple]:
  """(name, shape, std, mean) of every parameter, in the order the
  network applies them: He-normal hidden weights, the Q layer's weights
  with the variance of U(-0.03, 0.03), zero biases but the Q layer's
  -0.2."""
  out, cin, size = [], hp["pixels_frames"], hp["pixels_size"]
  for i, (filters, kernel, stride) in enumerate(hp["conv_layer_params"]):
    out.append((f"conv{i}.weight", (filters, cin, kernel, kernel),
                math.sqrt(2.0 / (cin * kernel * kernel)), 0.0))
    out.append((f"conv{i}.bias", (filters,), 0.0, 0.0))
    cin, size = filters, -(-size // stride)
  width = size * size * cin
  for j, units in enumerate(hp["fc_layer_params"]):
    out.append((f"fc{j}.weight", (units, width), math.sqrt(2.0 / width), 0.0))
    out.append((f"fc{j}.bias", (units,), 0.0, 0.0))
    width = units
  actions = hp["pixels_actions"]
  out.append(("head.weight", (actions, width), 0.03 / math.sqrt(3.0), 0.0))
  out.append(("head.bias", (actions,), 0.0, -0.2))
  return out


def q_values(w: Dict[str, torch.Tensor], obs: torch.Tensor, hp,
             precision: str) -> torch.Tensor:
  """[N, actions] float32 Q values of uint8 frames [N, H, W, F]."""
  x = obs.to(torch.float32) / 255.0
  x = x.permute(0, 3, 1, 2)
  size = hp["pixels_size"]
  for i, (_, kernel, stride) in enumerate(hp["conv_layer_params"]):
    lo, hi = common.same_padding(size, kernel, stride)
    x = F.pad(x, (lo, hi, lo, hi))
    x = F.relu(common.conv2d(x, w[f"conv{i}.weight"], w[f"conv{i}.bias"],
                             stride, precision))
    size = -(-size // stride)
  x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  for j in range(len(hp["fc_layer_params"])):
    x = F.relu(common.linear(x, w[f"fc{j}.weight"], w[f"fc{j}.bias"],
                             precision))
  return common.linear(x, w["head.weight"], w["head.bias"], precision)


def frame(hp, target: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  size, frames = hp["pixels_size"], hp["pixels_frames"]
  idx = torch.arange(size, device=target.device, dtype=torch.int64)
  f = torch.arange(frames, device=target.device, dtype=torch.int64)
  base = idx[:, None, None] * 3 + idx[None, :, None] * 5 + f * 7
  offset = 41 * target.to(torch.int64) + 13 * t.to(torch.int64)
  return ((base + offset[:, None, None, None]) % 251).to(torch.uint8)


class Env:
  """The synthetic frame task over B rows."""

  def __init__(self, hp, draws, batch: int):
    self.hp, self.draws, self.batch = hp, draws, batch
    self.target = draws.take("pixels_target", (batch,)).to(torch.int64)
    self.t = torch.zeros_like(self.target)
    self.step_type = torch.full_like(self.target, FIRST)
    self.obs = frame(hp, self.target, self.t)

  def step(self, action: torch.Tensor):
    """(reward, discount, next step type); the rows advance."""
    new_target = self.draws.take("pixels_step_target",
                                 (self.batch,)).to(torch.int64)
    reset_target = self.draws.take("pixels_target",
                                   (self.batch,)).to(torch.int64)
    restart = self.step_type == LAST
    reward = (action.to(torch.int64) == self.target).to(torch.float32)
    t = self.t + 1
    done = t >= self.hp["pixels_horizon"]
    step_type = torch.where(done, LAST, MID)
    discount = torch.where(done, 0.0, 1.0)
    self.target = torch.where(restart, reset_target, new_target)
    self.t = torch.where(restart, 0, t)
    self.step_type = torch.where(restart, FIRST, step_type)
    reward = torch.where(restart, 0.0, reward)
    discount = torch.where(restart, 1.0, discount)
    self.obs = frame(self.hp, self.target, self.t)
    return reward, discount, self.step_type


def follow(hp, weights: Dict[str, torch.Tensor], draws, initial_steps: int,
           iterations: int, train_steps: int, precision: str = "float32",
           actions: Optional[torch.Tensor] = None,
           fault: Optional[str] = None) -> dict:
  """The loop's first `initial_steps` collect steps, then `iterations`
  iterations (one collect step and one train step each) of which the
  first `train_steps` train steps are followed.

  With `actions` ([steps, B], the program's) the rows play those actions
  and each is judged: a row that explored must play its random draw, a
  greedy row's action is read against this Q (`greedy_gap`, the widest
  gap below the best). Without, the reference plays its own.
  `fault` plants a fault for reading limits: "half_batch" (the loss is
  the mean over the first half of the sample) or "altered" (row 0's
  first greedy action is the worst one).
  """
  device = weights["head.bias"].device
  batch, sample = hp["env_batch_size"], hp["sample_batch_size"]
  capacity = hp["replay_capacity"]
  steps = initial_steps + iterations
  if steps > capacity:
    raise ValueError("the reference follows an unwrapped ring only")
  online = {k: v.detach().clone().float().requires_grad_(True)
            for k, v in weights.items()}
  target = {k: v.detach().clone().float() for k, v in weights.items()}
  moments: dict = {}
  env = Env(hp, draws, batch)
  size, frames = hp["pixels_size"], hp["pixels_frames"]
  ring = {
      "step_type": torch.zeros(steps, batch, dtype=torch.int32,
                               device=device),
      "observation": torch.zeros(steps, batch, size, size, frames,
                                 dtype=torch.uint8, device=device),
      "action": torch.zeros(steps, batch, dtype=torch.int32, device=device),
      "next_step_type": torch.zeros(steps, batch, dtype=torch.int32,
                                    device=device),
      "reward": torch.zeros(steps, batch, device=device),
      "discount": torch.zeros(steps, batch, device=device)}
  out = {"greedy_gap": 0.0, "explore_mismatch": 0, "losses": [],
         "td_error": [], "grads": None, "before": None, "after": None}
  rows = torch.arange(batch, device=device)

  def collect(k: int):
    with torch.no_grad(), common.precision_flags(precision):
      q = q_values(online, env.obs, hp, precision)
    random_action = draws.take("random_action", (batch,)).to(torch.int64)
    explore = draws.take("explore", (batch,)) < hp["epsilon_greedy"]
    greedy = torch.argmax(q, dim=-1)
    if actions is None:
      if fault == "altered" and k == 0:
        greedy = greedy.clone()
        greedy[0] = torch.argmin(q[0])
      action = torch.where(explore, random_action, greedy)
    else:
      action = actions[k].to(torch.int64)
      gap = q.max(dim=-1).values - q[rows, action]
      gap = torch.where(explore, 0.0, gap)
      out["greedy_gap"] = max(out["greedy_gap"], float(gap.max()))
      out["explore_mismatch"] += int(
          (explore & (action != random_action)).sum())
    ring["step_type"][k] = env.step_type
    ring["observation"][k] = env.obs
    ring["action"][k] = action.to(torch.int32)
    reward, discount, next_step_type = env.step(action)
    ring["next_step_type"][k] = next_step_type
    ring["reward"][k] = reward
    ring["discount"][k] = discount

  def train(count: int, step: int):
    size_ = min(count, capacity)
    lo = count - size_
    t0 = lo + draws.take("replay_t0", (sample,)).to(torch.int64)
    row = draws.take("replay_rows", (sample,)).to(torch.int64)
    t1 = (t0 + 1) % capacity
    t0 = t0 % capacity
    with common.precision_flags(precision):
      q = q_values(online, ring["observation"][t0, row], hp, precision)
      q = q[torch.arange(sample, device=device),
            ring["action"][t0, row].to(torch.int64)]
      with torch.no_grad():
        next_q = q_values(target, ring["observation"][t1, row], hp,
                          precision).max(dim=-1).values
        td = (ring["reward"][t0, row]
              + hp["gamma"] * ring["discount"][t0, row] * next_q)
      err = (td - q).abs()
      quadratic = err.clamp(max=1.0)
      huber = 0.5 * quadratic**2 + (err - quadratic)
      huber = huber * (ring["step_type"][t0, row] != LAST).to(torch.float32)
      if fault == "half_batch":
        huber = huber[:sample // 2]
      loss = huber.mean()
      grads = torch.autograd.grad(loss, list(online.values()))
    valid = (ring["step_type"][t0, row] != LAST).to(torch.float32)
    out["td_error"].append((valid * (td - q)).detach())
    grads = dict(zip(online, grads))
    common.adam(online, grads, moments, step, hp["learning_rate"],
                hp["adam_eps"])
    if step % hp["target_update_period"] == 0:
      tau = hp["target_update_tau"]
      for k, v in target.items():
        v.mul_(1 - tau).add_(online[k].detach(), alpha=tau)
    return float(loss.detach()), grads

  for k in range(initial_steps):
    collect(k)
  out["before"] = snapshot(online, target)
  for i in range(iterations):
    collect(initial_steps + i)
    if i < train_steps:
      loss, grads = train(initial_steps + i + 1, i + 1)
      out["losses"].append({"loss": loss})
      if i == 0:
        out["grads"] = {f"q.{k}": g for k, g in grads.items()}
      if i + 1 == train_steps:
        out["after"] = snapshot(online, target)
  out["ring"] = ring
  out["actions"] = ring["action"]
  return out


def snapshot(online, target) -> Dict[str, torch.Tensor]:
  leaves_ = {f"q.{k}": v.detach().clone() for k, v in online.items()}
  leaves_.update({f"target.{k}": v.detach().clone()
                  for k, v in target.items()})
  return leaves_
