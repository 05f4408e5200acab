"""Plain reference of the fused SAC loop over the pendulum swing-up.

Written from the published descriptions, not from the program: Soft
Actor-Critic (Haarnoja et al. 2018, arXiv:1801.01290; the learned
temperature of arXiv:1812.05905, section 5): a tanh-squashed Gaussian
actor with a state-dependent log std, twin critics Q(s, a) over the
concatenation [s, a], each with a target critic; and the pendulum of
Gym's Pendulum-v1. The configuration file states the loop's order of
work:

  env      per row theta and theta_dot, reset from "pendulum_theta" and
           "pendulum_theta_dot" uniforms; a step clips the torque u to
           +-2, costs normalize(theta)^2 + 0.1 theta_dot^2 + 0.001 u^2,
           theta_dot += (3 g / 2 l * sin(theta) + 3 / (m l^2) * u) * dt
           (clipped to +-8), theta += theta_dot * dt; g 10, m = l = 1,
           dt 0.05; after `max_episode_steps` the step is LAST with
           discount 1 and the next one restarts the row. Reset draws are
           taken at every step, used or not.
  actor    mean and log std (clipped to [-20, 2]) from two ReLU layers
           and a linear head; u = mean + std * normal; action
           2 * tanh(u) within [-2, 2]; log pi = log N(u; mean, std) -
           log(1 - tanh(u)^2) - log 2, the squash's log-derivative taken
           as 2 (log 2 - u - softplus(-2u)).
  collect  the actor's sample with the "actor_noise" normal, one frame per
           row and step into the ring.
  train    the critic loss 0.5 * mean over the sample of (y - Q1)^2 +
           (y - Q2)^2, zero where s is LAST, with y = scale * r + gamma *
           d * (min(Q'1, Q'2)(s', a') - alpha * log pi(a'|s')) and a' from
           "sac_next_action_noise"; the actor loss mean(alpha * log pi(a|s)
           - min(Q1, Q2)(s, a)) with a from "sac_action_noise" and alpha
           held; the temperature loss mean(-log alpha * (log pi +
           target entropy)) with log pi held. All three read the
           parameters from before the step; then an Adam step each (the
           two critics under one optimizer) and the targets take
           tau * critic + (1 - tau) * target.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import common

FIRST, MID, LAST = 0, 1, 2
_G, _M, _L, _DT = 10.0, 1.0, 1.0, 0.05
_MAX_SPEED, _MAX_TORQUE = 8.0, 2.0
NETS = ("actor", "critic1", "critic2")


def _dense(prefix, sizes, head_std, head_out):
  out, width = [], sizes[0]
  for i, units in enumerate(sizes[1:]):
    out.append((f"{prefix}.l{i}.weight", (units, width),
                math.sqrt(2.0 / width), 0.0))
    out.append((f"{prefix}.l{i}.bias", (units,), 0.0, 0.0))
    width = units
  out.append((f"{prefix}.head.weight", (head_out, width), head_std(width),
              0.0))
  out.append((f"{prefix}.head.bias", (head_out,), 0.0, 0.0))
  return out


def leaves(hp) -> List[tuple]:
  """(name, shape, std, mean): He-normal hidden weights, a LeCun-normal
  actor head, critic heads with the variance of U(-0.003, 0.003), zero
  biases."""
  obs, act = hp["observation_size"], hp["action_size"]
  actor = _dense("actor", (obs,) + tuple(hp["actor_fc_layers"]),
                 lambda w: math.sqrt(1.0 / w), 2 * act)
  critics = []
  for name in ("critic1", "critic2"):
    critics += _dense(name, (obs + act,) + tuple(hp["critic_joint_fc_layers"]),
                      lambda w: 0.003 / math.sqrt(3.0), 1)
  return actor + critics


def _mlp(w, prefix, x, precision):
  i = 0
  while f"{prefix}.l{i}.weight" in w:
    x = F.relu(common.linear(x, w[f"{prefix}.l{i}.weight"],
                             w[f"{prefix}.l{i}.bias"], precision))
    i += 1
  return common.linear(x, w[f"{prefix}.head.weight"], w[f"{prefix}.head.bias"],
                       precision)


def actor_sample(w, obs, noise, precision):
  """(action, log pi) of the actor at `obs` with standard normals
  `noise` [N, act]."""
  out = _mlp(w, "actor", obs, precision)
  act = out.shape[-1] // 2
  mean, log_std = out[:, :act], out[:, act:].clamp(-20.0, 2.0)
  std = torch.exp(log_std)
  u = mean + std * noise
  log_normal = (-0.5 * ((u - mean) / std) ** 2 - log_std
                - 0.5 * math.log(2 * math.pi))
  log_det = math.log(_MAX_TORQUE) + 2.0 * (math.log(2.0) - u
                                           - F.softplus(-2.0 * u))
  action = _MAX_TORQUE * torch.tanh(u)
  return action, (log_normal - log_det).sum(dim=-1)


def critic(w, name, obs, action, precision):
  return _mlp(w, name, torch.cat([obs, action], dim=-1), precision)[:, 0]


def _normalize(x):
  return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class Env:
  """The pendulum over B rows."""

  def __init__(self, hp, draws, batch: int):
    self.hp, self.draws, self.batch = hp, draws, batch
    self.theta = draws.take("pendulum_theta", (batch,))
    self.theta_dot = draws.take("pendulum_theta_dot", (batch,))
    self.steps = torch.zeros(batch, dtype=torch.int64,
                             device=self.theta.device)
    self.step_type = torch.full_like(self.steps, FIRST)

  @property
  def obs(self):
    return torch.stack([torch.cos(self.theta), torch.sin(self.theta),
                        self.theta_dot], dim=-1)

  def step(self, action):
    reset_theta = self.draws.take("pendulum_theta", (self.batch,))
    reset_dot = self.draws.take("pendulum_theta_dot", (self.batch,))
    restart = self.step_type == LAST
    u = action[:, 0].clamp(-_MAX_TORQUE, _MAX_TORQUE)
    th, dot = self.theta, self.theta_dot
    cost = _normalize(th) ** 2 + 0.1 * dot**2 + 0.001 * u**2
    new_dot = (dot + (3 * _G / (2 * _L) * torch.sin(th)
                      + 3.0 / (_M * _L**2) * u) * _DT).clamp(-_MAX_SPEED,
                                                             _MAX_SPEED)
    new_th = th + new_dot * _DT
    steps = self.steps + 1
    step_type = torch.where(steps >= self.hp["max_episode_steps"], LAST, MID)
    self.theta = torch.where(restart, reset_theta, new_th)
    self.theta_dot = torch.where(restart, reset_dot, new_dot)
    self.steps = torch.where(restart, 0, steps)
    self.step_type = torch.where(restart, FIRST, step_type)
    reward = torch.where(restart, 0.0, -cost)
    return reward, torch.ones_like(reward), self.step_type


def follow(hp, weights: Dict[str, torch.Tensor], draws, initial_steps: int,
           iterations: int, train_steps: int, precision: str = "float32",
           actions: Optional[torch.Tensor] = None,
           fault: Optional[str] = None) -> dict:
  """`initial_steps` collect steps, then `iterations` iterations of one
  collect step and `train_steps_per_iteration` train steps, of which the
  first `train_steps` are followed.

  With `actions` ([steps, B, act], the program's) the rows play those and
  each is read against this actor's sample at the same draw
  (`collect_gap`, the widest absolute gap). `fault` plants a fault for
  reading limits: "half_batch" (every loss over the first half of the
  sample) or "altered" (row 0's first action negated).
  """
  device = weights["actor.head.bias"].device
  batch, sample = hp["env_batch_size"], hp["sample_batch_size"]
  capacity, act = hp["replay_capacity"], hp["action_size"]
  steps = initial_steps + iterations * hp["collect_steps_per_iteration"]
  if steps > capacity:
    raise ValueError("the reference follows an unwrapped ring only")
  w = {k: v.detach().clone().float().requires_grad_(True)
       for k, v in weights.items()}
  log_alpha = torch.tensor(float(hp["initial_log_alpha"]), device=device,
                           requires_grad=True)
  target = {k: v.detach().clone() for k, v in w.items()
            if k.startswith("critic")}
  moments: dict = {}
  env = Env(hp, draws, batch)
  ring = {
      "step_type": torch.zeros(steps, batch, dtype=torch.int32,
                               device=device),
      "observation": torch.zeros(steps, batch, hp["observation_size"],
                                 device=device),
      "action": torch.zeros(steps, batch, act, device=device),
      "next_step_type": torch.zeros(steps, batch, dtype=torch.int32,
                                    device=device),
      "reward": torch.zeros(steps, batch, device=device),
      "discount": torch.zeros(steps, batch, device=device)}
  out = {"collect_gap": 0.0, "losses": [], "grads": None, "before": None,
         "after": None}

  def collect(k: int):
    obs = env.obs
    noise = draws.take("actor_noise", (batch, act))
    with torch.no_grad(), common.precision_flags(precision):
      own, _ = actor_sample(w, obs, noise, precision)
    if actions is None:
      action = own.clamp(-_MAX_TORQUE, _MAX_TORQUE)
      if fault == "altered" and k == 0:
        action = action.clone()
        action[0] = -action[0]
    else:
      action = actions[k]
      out["collect_gap"] = max(out["collect_gap"],
                               float((action - own).abs().max()))
    ring["step_type"][k] = env.step_type
    ring["observation"][k] = obs
    ring["action"][k] = action
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
    next_noise = draws.take("sac_next_action_noise", (sample, act))
    noise = draws.take("sac_action_noise", (sample, act))
    obs, next_obs = ring["observation"][t0, row], ring["observation"][t1, row]
    action = ring["action"][t0, row]
    reward, discount = ring["reward"][t0, row], ring["discount"][t0, row]
    valid = (ring["step_type"][t0, row] != LAST).to(torch.float32)
    keep = sample // 2 if fault == "half_batch" else sample
    with common.precision_flags(precision):
      alpha = torch.exp(log_alpha)
      with torch.no_grad():
        next_action, next_log_pi = actor_sample(w, next_obs, next_noise,
                                                precision)
        target_q = torch.minimum(
            critic(target, "critic1", next_obs, next_action, precision),
            critic(target, "critic2", next_obs, next_action, precision))
        y = (hp["reward_scale_factor"] * reward + hp["gamma"] * discount
             * (target_q - alpha * next_log_pi))
      q1 = critic(w, "critic1", obs, action, precision)
      q2 = critic(w, "critic2", obs, action, precision)
      per_row = ((y - q1) ** 2 + (y - q2) ** 2) * valid
      critic_loss = 0.5 * per_row[:keep].mean()
      new_action, log_pi = actor_sample(w, obs, noise, precision)
      q = torch.minimum(critic(w, "critic1", obs, new_action, precision),
                        critic(w, "critic2", obs, new_action, precision))
      actor_loss = (alpha.detach() * log_pi - q)[:keep].mean()
      alpha_loss = (-log_alpha * (log_pi + hp["target_entropy"]).detach()
                    )[:keep].mean()
      critic_names = [k for k in w if k.startswith("critic")]
      actor_names = [k for k in w if k.startswith("actor")]
      g_critic = torch.autograd.grad(critic_loss,
                                     [w[k] for k in critic_names])
      g_actor = torch.autograd.grad(actor_loss, [w[k] for k in actor_names])
      (g_alpha,) = torch.autograd.grad(alpha_loss, [log_alpha])
    grads = dict(zip(critic_names, g_critic))
    grads.update(zip(actor_names, g_actor))
    lrs = {"critic": hp["critic_lr"], "actor": hp["actor_lr"]}
    for group, names in (("critic", critic_names), ("actor", actor_names)):
      common.adam({k: w[k] for k in names}, grads, moments, step, lrs[group])
    common.adam({"log_alpha": log_alpha}, {"log_alpha": g_alpha}, moments,
                step, hp["alpha_lr"])
    grads["log_alpha"] = g_alpha
    tau = hp["target_update_tau"]
    if step % hp["target_update_period"] == 0:
      with torch.no_grad():
        for k, v in target.items():
          v.mul_(1 - tau).add_(w[k].detach(), alpha=tau)
    return {"critic_loss": float(critic_loss.detach()),
            "actor_loss": float(actor_loss.detach()),
            "alpha_loss": float(alpha_loss.detach())}, grads

  for k in range(initial_steps):
    collect(k)
  out["before"] = snapshot(w, log_alpha, target)
  count, followed = initial_steps, 0
  for _ in range(iterations):
    for _ in range(hp["collect_steps_per_iteration"]):
      collect(count)
      count += 1
    for _ in range(hp["train_steps_per_iteration"]):
      if followed == train_steps:
        break
      losses, grads = train(count, followed + 1)
      followed += 1
      out["losses"].append(losses)
      if followed == 1:
        out["grads"] = grads
      if followed == train_steps:
        out["after"] = snapshot(w, log_alpha, target)
  out["ring"] = ring
  out["actions"] = ring["action"]
  return out


def snapshot(w, log_alpha, target) -> Dict[str, torch.Tensor]:
  leaves_ = {k: v.detach().clone() for k, v in w.items()}
  leaves_["log_alpha"] = log_alpha.detach().clone()
  leaves_.update({f"target_{k}": v.detach().clone()
                  for k, v in target.items()})
  return leaves_
