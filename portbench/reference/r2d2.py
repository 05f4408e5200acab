"""Plain reference of R2D2 in the fused loop over synthetic Atari frames.

Written from the published description, not from the program: R2D2
(Kapturowski et al. 2019, "Recurrent Experience Replay in Distributed
Reinforcement Learning", ICLR; sections 2-3, Table 1 and the appendix's
network): the Nature DQN's convolutions (32, 8x8, 4), (64, 4x4, 2),
(64, 3x3, 1) unpadded, a dense layer of 512 (ReLU after each), its output
concatenated with the one-hot previous action and the previous reward,
an LSTM, and dueling value and advantage streams of one hidden ReLU
layer each, Q = V + A - mean(A); trained on stored-state sequences with
burn-in, n-step double-Q targets under value rescaling and prioritized
sequence replay. The synthetic frames, their env and the order of the
loop's work are `reference/dqn.py`'s (its `Env`); the configuration file
states the rest:

  LSTM     gates from x W_x + h W_h + b in blocks i, f, g, o; c' = sig(f)
           c + sig(i) tanh(g), h' = sig(o) tanh(c'); a step whose frame is
           FIRST starts from c = h = 0 and sees previous action and reward
           0. A plain per-step loop; autograd takes the gradient.
  collect  epsilon-greedy over this network's Q with its own carry: where
           the "explore" uniform is below epsilon the "random_action" draw,
           else the argmax (the first of equal values). The ring keeps per
           frame the step, frame, action, next step type, reward and
           discount, and what the network read besides the frame: the
           carry it started from and the previous action and reward.
  sample   windows of T = burn-in + L frames may start at the ring slots
           that are multiples of the stride; a start's priority is set to
           the running max priority (1 at first) when its slot is written.
           Over the starts whose window lies within the frames written,
           p^alpha, its cumulative sum (in float64), and one "per_u" uniform per
           stratum: u_i = (i + per_u_i) / S * total, held below total *
           (1 - 1e-7); the start is the first whose cumulative sum passes
           u_i, in (slot, row) order. IS weight (N P)^-beta over its max,
           N the number of valid starts times the rows.
  train    from the carry stored at the window's first frame, the online
           and the target network each unroll the burn-in frames without
           gradient, then the L trained ones. For trained position t the
           n-step return sums gamma^k times the discounts before t + k
           times r_{t+k}, and stops at the first LAST frame t + j (j <= n)
           or at t + n, where it bootstraps h^-1(Q_target(s, argmax
           Q_online(s))) of that frame times gamma^j and the discounts;
           y = h(return), h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x. The
           loss: per sequence the mean of (y - Q(s_t, a_t))^2 over the
           positions that are not LAST and whose frame t + n lies in the
           window, times the IS weight, then the mean over the sequences;
           Adam; the sequence's new priority eta max |delta| + (1 - eta)
           mean |delta| + 1e-6 (the largest where a start is drawn twice);
           every `target_update_period` steps the target takes the online
           weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import common
from portbench.reference.dqn import FIRST, LAST, Env

PRIORITY_EPSILON = 1e-6
FAULTS = ("half_batch", "altered", "zero_carry", "no_rescaling")


def _valid_size(size: int, kernel: int, stride: int) -> int:
  return (size - kernel) // stride + 1


def leaves(hp) -> List[tuple]:
  """(name, shape, std, mean) of every parameter: He-normal convolutions
  and dense layers, the LSTM's input and recurrent weights normal with
  variance 1 / fan-in and a zero bias, the heads' weights with the
  variance of U(-0.03, 0.03) and biases -0.2, other biases 0."""
  out, cin, size = [], hp["pixels_frames"], hp["pixels_size"]
  for i, (filters, kernel, stride) in enumerate(hp["conv_layer_params"]):
    out.append((f"conv{i}.weight", (filters, cin, kernel, kernel),
                math.sqrt(2.0 / (cin * kernel * kernel)), 0.0))
    out.append((f"conv{i}.bias", (filters,), 0.0, 0.0))
    cin, size = filters, _valid_size(size, kernel, stride)
  width = size * size * cin
  for j, units in enumerate(hp["fc_layer_params"]):
    out.append((f"fc{j}.weight", (units, width), math.sqrt(2.0 / width), 0.0))
    out.append((f"fc{j}.bias", (units,), 0.0, 0.0))
    width = units
  actions, cells = hp["pixels_actions"], hp["lstm_size"]
  width += actions + 1
  out.append(("lstm.input_weight", (4 * cells, width),
              math.sqrt(1.0 / width), 0.0))
  out.append(("lstm.hidden_weight", (4 * cells, cells),
              math.sqrt(1.0 / cells), 0.0))
  out.append(("lstm.bias", (4 * cells,), 0.0, 0.0))
  head_std = 0.03 / math.sqrt(3.0)
  for stream, outputs in (("value", 1), ("advantage", actions)):
    width = cells
    for j, units in enumerate(hp["dueling_fc_layer_params"]):
      out.append((f"{stream}{j}.weight", (units, width),
                  math.sqrt(2.0 / width), 0.0))
      out.append((f"{stream}{j}.bias", (units,), 0.0, 0.0))
      width = units
    out.append((f"{stream}_head.weight", (outputs, width), head_std, 0.0))
    out.append((f"{stream}_head.bias", (outputs,), 0.0, -0.2))
  return out


def torso(w, frames: torch.Tensor, hp, precision: str) -> torch.Tensor:
  """[N, fc] features of uint8 frames [N, H, W, C]: unpadded
  convolutions, flattened in (row, column, channel) order."""
  x = frames.to(torch.float32) / 255.0
  x = x.permute(0, 3, 1, 2)
  for i, (_, _, stride) in enumerate(hp["conv_layer_params"]):
    x = F.relu(common.conv2d(x, w[f"conv{i}.weight"], w[f"conv{i}.bias"],
                             stride, precision))
  x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  for j in range(len(hp["fc_layer_params"])):
    x = F.relu(common.linear(x, w[f"fc{j}.weight"], w[f"fc{j}.bias"],
                             precision))
  return x


def lstm_step(w, x, c, h, first, precision: str):
  """One step of the LSTM over [B, in] inputs; rows whose frame is FIRST
  start from zeros."""
  keep = (~first).to(torch.float32)[:, None]
  c, h = c * keep, h * keep
  gates = (common.linear(x, w["lstm.input_weight"], w["lstm.bias"],
                         precision)
           + common.linear(h, w["lstm.hidden_weight"], None, precision))
  i, f, g, o = gates.chunk(4, dim=1)
  c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
  h = torch.sigmoid(o) * torch.tanh(c)
  return c, h


def heads(w, y, hp, precision: str) -> torch.Tensor:
  streams = {}
  for stream in ("value", "advantage"):
    x = y
    for j in range(len(hp["dueling_fc_layer_params"])):
      x = F.relu(common.linear(x, w[f"{stream}{j}.weight"],
                               w[f"{stream}{j}.bias"], precision))
    streams[stream] = common.linear(x, w[f"{stream}_head.weight"],
                                    w[f"{stream}_head.bias"], precision)
  a = streams["advantage"]
  return streams["value"] + a - a.mean(dim=-1, keepdim=True)


def step(w, frames, step_type, c, h, previous_action, previous_reward, hp,
         precision: str):
  """(Q [B, A], c, h) of one step of B rows."""
  first = step_type == FIRST
  keep = (~first).to(torch.float32)[:, None]
  actions = hp["pixels_actions"]
  x = torch.cat([torso(w, frames, hp, precision),
                 F.one_hot(previous_action.long(), actions).float() * keep,
                 previous_reward.float()[:, None] * keep], dim=1)
  c, h = lstm_step(w, x, c, h, first, precision)
  return heads(w, h, hp, precision), c, h


def rescale(x, eps):
  return torch.sign(x) * (torch.sqrt(x.abs() + 1) - 1) + eps * x


def unrescale(x, eps):
  """h^-1, in float64 by the closed form."""
  x = x.double()
  inner = (torch.sqrt(1 + 4 * eps * (x.abs() + 1 + eps)) - 1) / (2 * eps)
  return (torch.sign(x) * (inner**2 - 1)).float()


def unroll(w, window, start: int, stop: int, c, h, hp, precision: str):
  """(Q [S, stop - start, A] or None, c, h) of frames start .. stop - 1
  of `window` ({leaf: [S, T, ...]}) from the carry (c, h)."""
  q = []
  for t in range(start, stop):
    q_t, c, h = step(w, window["observation"][:, t],
                     window["step_type"][:, t], c, h,
                     window["previous_action"][:, t],
                     window["previous_reward"][:, t], hp, precision)
    q.append(q_t)
  return (torch.stack(q, dim=1) if q else None), c, h


def sequence_loss(online, target, window, weight, hp, precision: str,
                  fault: Optional[str] = None):
  """(loss, TD errors [S, M] (0 where not valid), valid positions per
  sequence [S]) of windows ({leaf: [S, T, ...]}, with the stored carry
  and previous action and reward of each frame) under IS weights [S]; M
  = T - burn-in - n."""
  burn, n = hp["burn_in"], hp["n_step_update"]
  length = window["step_type"].shape[1]
  sample = weight.shape[0]
  device = weight.device
  eps = hp["value_rescaling_eps"]
  h_fn, h_inv = (rescale, unrescale) if fault != "no_rescaling" else (
      lambda x, _: x, lambda x, _: x)
  c_on = c_tg = window["c"][:, 0]
  h_on = h_tg = window["h"][:, 0]
  if fault == "zero_carry":
    c_on = c_tg = h_on = h_tg = torch.zeros_like(c_on)
  else:
    with torch.no_grad():
      _, c_on, h_on = unroll(online, window, 0, burn, c_on, h_on, hp,
                             precision)
      _, c_tg, h_tg = unroll(target, window, 0, burn, c_tg, h_tg, hp,
                             precision)
  q_all, _, _ = unroll(online, window, burn, length, c_on, h_on, hp,
                       precision)
  with torch.no_grad():
    target_all, _, _ = unroll(target, window, burn, length, c_tg, h_tg, hp,
                              precision)
    best = torch.argmax(q_all.detach(), dim=-1)
    values = h_inv(target_all.gather(2, best[..., None])[..., 0], eps)
  positions = length - burn - n
  q_taken = q_all.gather(
      2, window["action"][:, burn:].long()[..., None])[..., 0]
  reward = window["reward"][:, burn:]
  discount = window["discount"][:, burn:]
  last = window["step_type"][:, burn:] == LAST
  targets = torch.zeros(sample, positions, device=device)
  valid = torch.zeros(sample, positions, device=device)
  for i in range(positions):
    total = torch.zeros(sample, device=device)
    scale = torch.ones(sample, device=device)
    running = torch.ones(sample, dtype=torch.bool, device=device)
    for k in range(n):
      total = total + torch.where(running, scale * reward[:, i + k], 0.0)
      scale = scale * hp["gamma"] * discount[:, i + k]
      stop = running & (last[:, i + k + 1] | (k + 1 == n))
      total = total + torch.where(stop, scale * values[:, i + k + 1], 0.0)
      running = running & ~last[:, i + k + 1]
    targets[:, i] = h_fn(total, eps)
    valid[:, i] = (~last[:, i]).float()
  delta = (targets - q_taken[:, :positions]) * valid
  count_valid = valid.sum(dim=1).clamp_min(1.0)
  weighted = (delta**2).sum(dim=1) / count_valid * weight
  if fault == "half_batch":
    weighted = weighted[:sample // 2]
  return weighted.mean(), delta, count_valid


def priorities_of(delta, count_valid, hp):
  """Each sequence's priority from its TD errors [S, M]."""
  magnitude = delta.detach().abs()
  return (hp["priority_eta"] * magnitude.max(dim=1).values
          + (1 - hp["priority_eta"]) * magnitude.sum(dim=1) / count_valid)


def follow(hp, weights: Dict[str, torch.Tensor], draws, initial_steps: int,
           iterations: int, train_steps: int, precision: str = "float32",
           actions: Optional[torch.Tensor] = None,
           fault: Optional[str] = None) -> dict:
  """The loop's first `initial_steps` collect steps, then `iterations`
  iterations (one collect step and one train step each) of which the
  first `train_steps` train steps are followed.

  With `actions` ([steps, B], the program's) the rows play those actions
  and each is judged (`greedy_gap`, `explore_mismatch`); without, the
  reference plays its own. `fault` plants one of `FAULTS`: "half_batch"
  (the loss over the first half of the sample), "altered" (row 0's first
  greedy action is the worst one), "zero_carry" (the trained frames
  unrolled from a zero carry, no stored carry and no burn-in),
  "no_rescaling" (h and h^-1 the identity).
  """
  if fault is not None and fault not in FAULTS:
    raise ValueError(f"unknown fault {fault!r}")
  device = weights["advantage_head.bias"].device
  batch, sample = hp["env_batch_size"], hp["sample_batch_size"]
  capacity, stride = hp["replay_capacity"], hp["sequence_stride"]
  length = hp["train_sequence_length"]
  steps = initial_steps + iterations
  if steps > capacity:
    raise ValueError("the reference follows an unwrapped ring only")
  cells = hp["lstm_size"]
  online = {k: v.detach().clone().float().requires_grad_(True)
            for k, v in weights.items()}
  target = {k: v.detach().clone().float() for k, v in weights.items()}
  moments: dict = {}
  env = Env(hp, draws, batch)
  size = hp["pixels_size"]

  def zeros(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device=device)

  ring = {"step_type": zeros(steps, batch, dtype=torch.int32),
          "observation": zeros(steps, batch, size, size, hp["pixels_frames"],
                               dtype=torch.uint8),
          "action": zeros(steps, batch, dtype=torch.int32),
          "next_step_type": zeros(steps, batch, dtype=torch.int32),
          "reward": zeros(steps, batch), "discount": zeros(steps, batch),
          "c": zeros(steps, batch, cells), "h": zeros(steps, batch, cells),
          "previous_action": zeros(steps, batch, dtype=torch.int32),
          "previous_reward": zeros(steps, batch)}
  priorities = zeros(capacity, batch)
  max_priority = [1.0]
  out = {"greedy_gap": 0.0, "explore_mismatch": 0, "losses": [],
         "td_error": [], "grads": None, "before": None, "after": None}
  rows = torch.arange(batch, device=device)
  carry = {"c": zeros(batch, cells), "h": zeros(batch, cells),
           "previous_action": zeros(batch, dtype=torch.int32),
           "reward": zeros(batch)}

  def collect(k: int):
    first = env.step_type == FIRST
    for key in ("c", "h", "previous_action"):
      carry[key] = torch.where(first[:, None] if carry[key].dim() > 1
                               else first, 0, carry[key])
    with torch.no_grad(), common.precision_flags(precision):
      q, c, h = step(online, env.obs, env.step_type, carry["c"], carry["h"],
                     carry["previous_action"], carry["reward"], hp,
                     precision)
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
    ring["c"][k], ring["h"][k] = carry["c"], carry["h"]
    ring["previous_action"][k] = carry["previous_action"]
    ring["previous_reward"][k] = carry["reward"]
    if (k % capacity) % stride == 0:
      priorities[k % capacity] = max_priority[0]
    reward, discount, next_step_type = env.step(action)
    ring["next_step_type"][k] = next_step_type
    ring["reward"][k] = reward
    ring["discount"][k] = discount
    carry.update(c=c, h=h, previous_action=action.to(torch.int32),
                 reward=reward)

  def draw(count: int):
    """(window start time ids, rows, IS weights) of one prioritized
    sample."""
    held = min(count, capacity)
    last = count - 1
    starts = torch.arange(0, capacity, stride, device=device)
    ids = last - torch.remainder(last - starts, capacity)
    valid = (ids >= 0) & (ids >= count - held) & (ids <= count - length)
    mass = torch.where(valid[:, None],
                       priorities[starts].double()**hp["priority_exponent"],
                       0.0).reshape(-1)
    cdf = torch.cumsum(mass, 0)
    total = cdf[-1]
    u = draws.take("per_u", (sample,)).double()
    u = (torch.arange(sample, device=device, dtype=torch.float64) + u) \
        / sample * total
    u = torch.minimum(u, total * (1.0 - 1e-7))
    index = torch.searchsorted(cdf, u, right=True).clamp_max(mass.numel() - 1)
    probability = mass[index] / total
    n_valid = int(valid.sum()) * batch
    weight = (n_valid * probability)**(-hp["importance_exponent"])
    weight = (weight / weight.max()).float()
    return ids[index // batch], index % batch, weight

  def train(count: int, train_step: int):
    t0, row, weight = draw(count)
    frames = t0[:, None] + torch.arange(length, device=device)
    window = {k: v[frames, row[:, None]] for k, v in ring.items()}
    with common.precision_flags(precision):
      loss, delta, count_valid = sequence_loss(online, target, window, weight,
                                               hp, precision, fault)
      grads = torch.autograd.grad(loss, list(online.values()))
    priority = priorities_of(delta, count_valid, hp)
    trained = length - hp["burn_in"]
    out["td_error"].append(F.pad(delta.detach(),
                                 (0, trained - delta.shape[1])))
    grads = dict(zip(online, grads))
    common.adam(online, grads, moments, train_step, hp["learning_rate"],
                hp["adam_eps"])
    if train_step % hp["target_update_period"] == 0:
      tau = hp["target_update_tau"]
      for k, v in target.items():
        v.mul_(1 - tau).add_(online[k].detach(), alpha=tau)
    new = priority + PRIORITY_EPSILON
    slots = t0 % capacity
    for j in range(sample):
      s, r = int(slots[j]), int(row[j])
      drawn_before = bool(((slots[:j] == s) & (row[:j] == r)).any())
      value = float(new[j])
      priorities[s, r] = max(float(priorities[s, r]), value) \
          if drawn_before else value
    max_priority[0] = max(max_priority[0], float(new.max()))
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
