"""Plain reference of QT-Opt's grasping Q-function in the fused loop.

Written from the published description, not from the program: QT-Opt
(Kalashnikov et al. 2018, arXiv:1806.10293, the figure of the Q-function
and section 4; the image stack of Levine et al. 2016). The network:

  torso  a uint8 image [S, S, 3] scaled by 1/255; Conv(64, 6x6, stride 2)
         unpadded, ReLU, MaxPool(3, 3); six Conv(64, 5x5) with XLA's SAME
         padding, ReLU; MaxPool(3, 3).
  merge  the action (8) and the gripper's state (2) concatenated, Dense
         256, ReLU, Dense 64, ReLU, added to every position of the map.
  head   six Conv(64, 3x3) SAME, ReLU; MaxPool(2, 2); three Conv(64, 3x3)
         SAME, ReLU; flattened in (row, column, channel) order; Dense 64,
         ReLU, Dense 64, ReLU, Dense 1: the logit; Q = sigmoid(logit).

The action enters after the torso, so a row's image features are computed
once and every candidate of the row is scored on them: the same
arithmetic. The env is the synthetic grasp the configuration states (its
frame, moves and ends are written out in `Env`). The loop, per step: the
collect policy is epsilon-greedy over CEM on the target network (explore
where the "explore" uniform is below epsilon; the random action is the
"random_action" draws: 5 uniforms u as -1 + 2u, then a category as a
one-hot); the ring keeps per frame the step type, image, gripper state,
action, next step type, reward and discount. A train step samples S
one-step transitions uniformly ("replay_t0", "replay_rows"); the target
is r + gamma d min(Q_delayed, Q_delayed_2)(s', a*), a* CEM's action on the
target network at s'; the loss is the mean over the sample of the
cross-entropy of sigmoid(logit Q(s, a)) against the target, zero where
s is LAST; Adam; every `target_update_period` steps the target takes the
online weights (tau 1), every `delayed_target_update_period` the second
delayed network the first's and the first the target's.

CEM, for B rows: a Gaussian over the 5 continuous entries (mean 0,
standard deviation 2 x 0.33) and a categorical over the 3 commands
(probabilities 1/3). Each of `iterations` rounds draws N candidates: the
"cem_normal" normals [N, B, 5] scaled and shifted, clipped to [-1, 1],
and a Gumbel-max category of the "cem_categorical" uniforms [N, B, 3]
(argmax of log p + -log(-log u)); scores them, keeps the E best by logit
(as by Q) and refits: the elites' mean, their variance plus 1e-6, and
their one-hots' mean plus 1e-6, renormalized. The answer is the clipped
mean and the most probable command.

Judging a program's CEM: its elites of every round come with its draws
(site `ELITES`, kept by the program's adapter). The reference scores the
same candidates; `cem_gap` is the widest gap, over every round and row,
of this Q at its own E-th best candidate above this Q at the worst of the
program's elites (0 where they are the same set; a near-tie may flip
one); the reference then refits to the program's elites, so it follows
the program's CEM to its answer, and for each collect row that did not
explore, the gap of this Q at that answer from this Q at the played
action enters `cem_gap` too. The TD targets are taken at the answers so
followed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import common

FIRST, MID, LAST = 0, 1, 2
ELITES = "program.cem_elites"
FAULTS = ("half_batch", "altered")
OBJECT_RADIUS = 0.1
GRIPPER_HALF_WIDTH = 0.06
CONTINUOUS, COMMANDS = 5, 3
INITIAL_STD = 0.33


def _pools(pools) -> dict:
  return {layer: (kernel, stride) for layer, kernel, stride in pools}


def _conv_out(size, kernel, stride, padding):
  return -(-size // stride) if padding == "SAME" else (
      (size - kernel) // stride + 1)


def map_size(hp) -> int:
  size, pools = hp["image_size"], _pools(hp["torso_max_pools"])
  for i, ((_, kernel, stride), padding) in enumerate(zip(
      hp["torso_conv_layer_params"], hp["torso_padding"])):
    size = _conv_out(size, kernel, stride, padding)
    if i in pools:
      size = _conv_out(size, *pools[i], "VALID")
  return size


def head_size(hp) -> int:
  size, pools = map_size(hp), _pools(hp["head_max_pools"])
  for i, (_, kernel, stride) in enumerate(hp["head_conv_layer_params"]):
    size = _conv_out(size, kernel, stride, "SAME")
    if i in pools:
      size = _conv_out(size, *pools[i], "VALID")
  return size


def leaves(hp) -> List[tuple]:
  """(name, shape, std, mean) of every parameter: He-normal convolutions
  and dense layers (std sqrt(2 / fan-in)), zero biases, and a logit layer
  with the variance of U(-0.03, 0.03)."""
  out, cin = [], 3
  for i, (filters, kernel, _) in enumerate(hp["torso_conv_layer_params"]):
    out.append((f"torso{i}.weight", (filters, cin, kernel, kernel),
                math.sqrt(2.0 / (cin * kernel * kernel)), 0.0))
    out.append((f"torso{i}.bias", (filters,), 0.0, 0.0))
    cin = filters
  width = CONTINUOUS + COMMANDS + 2
  for j, units in enumerate(hp["merge_fc_layer_params"]):
    out.append((f"merge{j}.weight", (units, width), math.sqrt(2.0 / width),
                0.0))
    out.append((f"merge{j}.bias", (units,), 0.0, 0.0))
    width = units
  for i, (filters, kernel, _) in enumerate(hp["head_conv_layer_params"]):
    out.append((f"head{i}.weight", (filters, cin, kernel, kernel),
                math.sqrt(2.0 / (cin * kernel * kernel)), 0.0))
    out.append((f"head{i}.bias", (filters,), 0.0, 0.0))
    cin = filters
  width = head_size(hp) ** 2 * cin
  for j, units in enumerate(hp["head_fc_layer_params"]):
    out.append((f"fc{j}.weight", (units, width), math.sqrt(2.0 / width), 0.0))
    out.append((f"fc{j}.bias", (units,), 0.0, 0.0))
    width = units
  out.append(("logit.weight", (1, width), 0.03 / math.sqrt(3.0), 0.0))
  out.append(("logit.bias", (1,), 0.0, 0.0))
  return out


def _conv(x, w, name, stride, padding, precision):
  weight = w[f"{name}.weight"]
  if padding == "SAME":
    kernel = weight.shape[-1]
    lo, hi = common.same_padding(x.shape[-1], kernel, stride)
    x = F.pad(x, (lo, hi, lo, hi))
  return F.relu(common.conv2d(x, weight, w[f"{name}.bias"], stride,
                              precision))


def torso(w, images: torch.Tensor, hp, precision: str) -> torch.Tensor:
  """[B, C, H, W] features of uint8 images [B, S, S, 3]."""
  x = (images.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
  pools = _pools(hp["torso_max_pools"])
  for i, ((_, _, stride), padding) in enumerate(zip(
      hp["torso_conv_layer_params"], hp["torso_padding"])):
    x = _conv(x, w, f"torso{i}", stride, padding, precision)
    if i in pools:
      x = F.max_pool2d(x, *pools[i])
  return x


def head(w, features, action, state, hp, precision: str) -> torch.Tensor:
  """Logits [N, B] of candidates [N, B, 8] (or [B] of [B, 8]) on the
  rows' features [B, C, H, W] and gripper states [B, 2]."""
  lead = tuple(action.shape[:-1])
  x = torch.cat([action, state.expand(lead + (state.shape[-1],))], -1)
  for j in range(len(hp["merge_fc_layer_params"])):
    x = F.relu(common.linear(x, w[f"merge{j}.weight"], w[f"merge{j}.bias"],
                             precision))
  x = (features + x[..., None, None]).reshape((-1,) + features.shape[1:])
  pools = _pools(hp["head_max_pools"])
  for i, (_, _, stride) in enumerate(hp["head_conv_layer_params"]):
    x = _conv(x, w, f"head{i}", stride, "SAME", precision)
    if i in pools:
      x = F.max_pool2d(x, *pools[i])
  x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  for j in range(len(hp["head_fc_layer_params"])):
    x = F.relu(common.linear(x, w[f"fc{j}.weight"], w[f"fc{j}.bias"],
                             precision))
  return common.linear(x, w["logit.weight"], w["logit.bias"],
                       precision)[:, 0].reshape(lead)


def logits(w, obs, action, hp, precision: str) -> torch.Tensor:
  return head(w, torso(w, obs["image"], hp, precision), action,
              obs["state"], hp, precision)


class Env:
  """The synthetic grasp over B rows (`agents_tpu_torch`'s
  `SyntheticGrasp`, as the configuration file states it)."""

  def __init__(self, hp, draws, batch: int):
    self.hp, self.draws, self.batch = hp, draws, batch
    self.object_xy = draws.take("grasp_object", (batch, 2))
    self.device = device = self.object_xy.device
    size = hp["image_size"]
    i = torch.arange(size, dtype=torch.int32, device=device)
    c = torch.arange(3, dtype=torch.int32, device=device)
    self.texture = ((i[:, None, None] * 3 + i[None, :, None] * 5 + c * 7)
                    % 64 + 32).to(torch.uint8)
    self.centres = (i.to(torch.float32) + 0.5) * (2.0 / size) - 1.0
    self.start = torch.tensor([0.0, 0.0, 1.0], device=device)
    self.gripper = self.start.expand(batch, 3)
    self.closed = torch.zeros(batch, device=device)
    self.t = torch.zeros(batch, dtype=torch.int64, device=device)
    self.step_type = torch.full((batch,), FIRST, dtype=torch.int64,
                                device=device)

  def obs(self):
    u, v = self.centres[None, :, None], self.centres[None, None, :]
    ox = self.object_xy[:, 0, None, None]
    oy = self.object_xy[:, 1, None, None]
    disc = (v - ox) * (v - ox) + (u - oy) * (u - oy) < (
        OBJECT_RADIUS * OBJECT_RADIUS)
    gx, gy = self.gripper[:, 0, None, None], self.gripper[:, 1, None, None]
    square = ((v - gx).abs() < GRIPPER_HALF_WIDTH) & (
        (u - gy).abs() < GRIPPER_HALF_WIDTH)
    colour = torch.stack([
        torch.full((self.batch,), 40, dtype=torch.uint8, device=self.device),
        (55.0 + 200.0 * (1.0 - self.gripper[:, 2])).to(torch.uint8),
        torch.where(self.closed > 0, 200, 40).to(torch.uint8)], -1)
    image = torch.where(disc[..., None], torch.tensor(
        [200, 40, 40], dtype=torch.uint8, device=self.device), self.texture)
    image = torch.where(square[..., None], colour[:, None, None, :], image)
    return {"image": image,
            "state": torch.stack([self.closed, self.gripper[:, 2]], -1)}

  def step(self, action: torch.Tensor):
    """(reward, discount, next step type); the rows advance, and rows
    whose step was LAST restart at a fresh "grasp_object" draw."""
    hp = self.hp
    reset_xy = self.draws.take("grasp_object", (self.batch, 2))
    restart = self.step_type == LAST
    low = torch.tensor([-1.0, -1.0, 0.0], device=self.device)
    gripper = torch.minimum(torch.maximum(
        self.gripper + hp["step_size"] * action[:, :3], low),
        torch.ones(3, device=self.device))
    command = torch.argmax(action[:, CONTINUOUS:], dim=-1)
    close, open_, end = command == 0, command == 1, command == 2
    dx = gripper[:, 0] - self.object_xy[:, 0]
    dy = gripper[:, 1] - self.object_xy[:, 1]
    dz = gripper[:, 2]
    success = close & (dx * dx + dy * dy + dz * dz
                       < hp["grasp_radius"] ** 2)
    closed = torch.where(close, 1.0, torch.where(open_, 0.0, self.closed))
    t = self.t + 1
    done = success | end | (t >= hp["horizon"])
    reward = torch.where(restart, 0.0, success.to(torch.float32))
    discount = torch.where(restart | ~done, 1.0, 0.0)
    step_type = torch.where(restart, FIRST, torch.where(done, LAST, MID))
    self.object_xy = torch.where(restart[:, None], reset_xy, self.object_xy)
    self.gripper = torch.where(restart[:, None], self.start, gripper)
    self.closed = torch.where(restart, 0.0, closed)
    self.t = torch.where(restart, 0, t)
    self.step_type = step_type
    return reward, discount, step_type


class Cem:
  """CEM over B rows on one network's logits, judging or playing."""

  def __init__(self, hp, draws, precision, elites=None):
    self.hp, self.draws, self.precision = hp, draws, precision
    self.given = elites          # a program's elites, in order, or None
    self.own: List[torch.Tensor] = []
    self.gap = 0.0

  def _elites(self, shape):
    if self.given is None:
      return self.draws.take(ELITES, shape)
    if not self.given:
      raise LookupError("no elites left")
    value = self.given.pop(0)
    if tuple(value.shape) != tuple(shape):
      raise ValueError(f"elites {tuple(value.shape)}, asked {shape}")
    return value

  def __call__(self, w, obs, judge: bool):
    """(answer [B, 8], the last round's candidates [N, B, 8] and Q [N,
    B]). Judging, the rounds refit to the program's elites and
    `self.gap` widens; else to this network's own, kept in `self.own`."""
    hp, precision = self.hp, self.precision
    n, e = hp["cem_num_samples"], hp["cem_num_elites"]
    b = obs["state"].shape[0]
    device = obs["state"].device
    mean = torch.zeros(b, CONTINUOUS, device=device)
    var = (torch.full((b, CONTINUOUS), 2.0, device=device)
           * INITIAL_STD) ** 2
    probs = torch.full((b, COMMANDS), 1.0 / COMMANDS, device=device)
    rows = torch.arange(b, device=device)[:, None]
    with torch.no_grad(), common.precision_flags(precision):
      features = torso(w, obs["image"], hp, precision)
      for _ in range(hp["cem_num_iterations"]):
        eps = self.draws.take("cem_normal", (n, b, CONTINUOUS))
        cont = torch.clamp(mean[None] + torch.sqrt(var)[None] * eps, -1.0,
                           1.0)
        u = self.draws.take("cem_categorical", (n, b, COMMANDS))
        gumbel = -torch.log(-torch.log(u))
        logp = torch.log(torch.clamp(probs, min=1e-9))
        command = torch.argmax(logp[None] + gumbel, dim=-1)
        candidates = torch.cat([cont, F.one_hot(command, COMMANDS).float()],
                               -1)
        score = head(w, features, candidates, obs["state"], hp, precision)
        q = torch.sigmoid(score)
        own = torch.topk(score.T, e, dim=-1).indices              # [B, E]
        if judge:
          elites = self._elites((b, e)).to(device, torch.int64)
          kth = q.T.gather(1, own).min(dim=1).values
          worst = q.T.gather(1, elites).min(dim=1).values
          self.gap = max(self.gap, float((kth - worst).max()))
        else:
          elites = own
          self.own.append(own)
        chosen = candidates.transpose(0, 1)[rows, elites]        # [B, E, 8]
        mean = chosen[..., :CONTINUOUS].mean(dim=1)
        var = torch.square(chosen[..., :CONTINUOUS]
                           - mean[:, None]).mean(dim=1) + 1e-6
        probs = chosen[..., CONTINUOUS:].mean(dim=1) + 1e-6
        probs = probs / probs.sum(dim=-1, keepdim=True)
    answer = torch.cat([torch.clamp(mean, -1.0, 1.0), F.one_hot(
        torch.argmax(probs, dim=-1), COMMANDS).float()], -1)
    return answer, candidates, q


def follow(hp, weights: Dict[str, torch.Tensor], draws, initial_steps: int,
           iterations: int, train_steps: int, precision: str = "float32",
           actions=None, fault: Optional[str] = None) -> dict:
  """The loop's first `initial_steps` collect steps, then `iterations`
  iterations (one collect step and one train step each) of which the
  first `train_steps` train steps are followed.

  With `actions` the run judges another's: the program's ring actions
  ([steps, B, 8]), its CEM elites then coming with the draws, or what
  this function returned as ``"actions"`` for another precision or a
  fault (``{"ring": ..., "elites": [...]}``). The rows play those actions
  and each is judged (`cem_gap`, `explore_mismatch`); without, the
  reference plays its own. `fault` plants one of `FAULTS`: "half_batch"
  (the loss over the first half of the sample), "altered" (row 0's first
  greedy action is the worst candidate of its last round).
  """
  if fault is not None and fault not in FAULTS:
    raise ValueError(f"unknown fault {fault!r}")
  device = weights["logit.bias"].device
  batch, sample = hp["env_batch_size"], hp["sample_batch_size"]
  capacity, gamma = hp["replay_capacity"], hp["gamma"]
  steps = initial_steps + iterations
  if steps > capacity:
    raise ValueError("the reference follows an unwrapped ring only")
  judge = actions is not None
  given = None
  if isinstance(actions, dict):
    actions, given = actions["ring"], list(actions["elites"])
  online = {k: v.detach().clone().float().requires_grad_(True)
            for k, v in weights.items()}
  target = {k: v.detach().clone().float() for k, v in weights.items()}
  delayed = [{k: v.clone() for k, v in target.items()} for _ in range(2)]
  moments: dict = {}
  cem = Cem(hp, draws, precision, given)
  env = Env(hp, draws, batch)
  size = hp["image_size"]

  def zeros(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device=device)

  ring = {"step_type": zeros(steps, batch, dtype=torch.int32),
          "image": zeros(steps, batch, size, size, 3, dtype=torch.uint8),
          "gripper_state": zeros(steps, batch, 2),
          "action": zeros(steps, batch, CONTINUOUS + COMMANDS),
          "next_step_type": zeros(steps, batch, dtype=torch.int32),
          "reward": zeros(steps, batch), "discount": zeros(steps, batch)}
  out = {"cem_gap": 0.0, "explore_mismatch": 0, "losses": [],
         "td_error": [], "grads": None, "before": None, "after": None}

  def collect(k: int):
    obs = env.obs()
    greedy, candidates, q = cem(target, obs, judge)
    uniforms = draws.take("random_action", (batch, CONTINUOUS))
    command = draws.take("random_action", (batch,))
    random_action = torch.cat([
        (-1.0 + uniforms.double() * 2.0).float(),
        F.one_hot(command.long(), COMMANDS).float()], -1)
    explore = draws.take("explore", (batch,)) < hp["epsilon_greedy"]
    if not judge:
      if fault == "altered" and k == 0:
        greedy = greedy.clone()
        greedy[0] = candidates[torch.argmin(q[:, 0]), 0]
      action = torch.where(explore[:, None], random_action, greedy)
    else:
      action = actions[k].to(device, torch.float32)
      with torch.no_grad(), common.precision_flags(precision):
        both = logits(target, obs, torch.stack([greedy, action]), hp,
                      precision)
      gap = (torch.sigmoid(both[0]) - torch.sigmoid(both[1])).abs()
      gap = torch.where(explore, 0.0, gap)
      out["cem_gap"] = max(out["cem_gap"], float(gap.max()))
      out["explore_mismatch"] += int(
          (explore & (action != random_action).any(dim=-1)).sum())
    ring["step_type"][k] = env.step_type
    ring["image"][k] = obs["image"]
    ring["gripper_state"][k] = obs["state"]
    ring["action"][k] = action
    reward, discount, next_step_type = env.step(action)
    ring["next_step_type"][k] = next_step_type
    ring["reward"][k] = reward
    ring["discount"][k] = discount

  def train(count: int, step: int):
    lo = count - min(count, capacity)
    t0 = lo + draws.take("replay_t0", (sample,)).to(torch.int64)
    row = draws.take("replay_rows", (sample,)).to(torch.int64)
    t1 = (t0 + 1) % capacity
    t0 = t0 % capacity
    obs = {"image": ring["image"][t0, row],
           "state": ring["gripper_state"][t0, row]}
    next_obs = {"image": ring["image"][t1, row],
                "state": ring["gripper_state"][t1, row]}
    next_action, _, _ = cem(target, next_obs, judge)
    with common.precision_flags(precision):
      with torch.no_grad():
        next_q = torch.minimum(
            torch.sigmoid(logits(delayed[0], next_obs, next_action, hp,
                                 precision)),
            torch.sigmoid(logits(delayed[1], next_obs, next_action, hp,
                                 precision)))
        td = (ring["reward"][t0, row]
              + gamma * ring["discount"][t0, row] * next_q)
      score = logits(online, obs, ring["action"][t0, row], hp, precision)
      valid = (ring["step_type"][t0, row] != LAST).to(torch.float32)
      loss = F.binary_cross_entropy_with_logits(score, td,
                                                reduction="none") * valid
      if fault == "half_batch":
        loss = loss[:sample // 2]
      loss = loss.mean()
      grads = torch.autograd.grad(loss, list(online.values()))
    out["td_error"].append((valid * (td - torch.sigmoid(score))).detach())
    grads = dict(zip(online, grads))
    common.adam(online, grads, moments, step, hp["learning_rate"])
    if step % hp["delayed_target_update_period"] == 0:
      for source, dest in ((delayed[0], delayed[1]), (target, delayed[0])):
        for k, v in dest.items():
          v.copy_(source[k])
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
  out["cem_gap"] = max(out["cem_gap"], cem.gap)
  out["ring"] = ring
  out["actions"] = {"ring": ring["action"], "elites": cem.own}
  return out


def snapshot(online, target) -> Dict[str, torch.Tensor]:
  leaves_ = {f"q.{k}": v.detach().clone() for k, v in online.items()}
  leaves_.update({f"target.{k}": v.detach().clone()
                  for k, v in target.items()})
  return leaves_
