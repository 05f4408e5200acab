"""Distributed SAC with the PyTorch port: the standalone collect job.

Port of ``examples/sac_collect_job.py`` with the same flags and defaults:
an actor process that steps a `BatchedPyEnvironment` of host envs with
the newest collect policy and streams experience to the learner
(`examples/sac_train_job_torch.py`). Each tick pushes the overlapping pair
(frame[t-1], frame[t]) of every row as one [2, ...] record into the
learner's shared-memory ingest ring (`replay_buffers/host_ingest.py`),
waiting for ring space rather than dropping (Reverb-style producer
backpressure); the learner's replay then holds independent 2-step items.

The agent, the envs and the `JittedPyPolicy` live on the CPU, always:
this process never touches the card. Weights arrive through the learner's
shared-memory `VariableContainer` (`--weights_shm`) or, without it, as in
the JAX job, from the learner's `PolicySaver` exports: every
`--policy_poll_ticks` ticks the collector reads
``root_dir/policies/collect_policy/policy_manifest.json`` and, when its
train step changed, loads that export's params. Until the first weights,
and for `--random_ticks` ticks, actions are uniform random.

On SIGTERM the job finishes its tick, closes its ring handle and prints
its last line (ticks, items pushed, each weight snapshot it took, from
the store or an export, as [step, CRC-32 of its bytes], and each store
poll up to the first snapshot as [tick, "no segment" | "empty" | [step,
writes]]), so a learner that stops it knows what was pushed and when the
collector first saw weights.

Usage:
  python examples/sac_collect_job_torch.py --root_dir=/tmp/dist_sac \\
      --ring=sac_ring_0 --env_name=Pendulum-v1 --env_batch_size=8 \\
      --weights_shm=sac_weights
"""
import argparse
import json
import os
import signal
import sys
import time
import zlib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def parse_args(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--root_dir", required=True)
  parser.add_argument("--ring", default="sac_ring_0")
  parser.add_argument("--env_name", default="Pendulum-v1")
  parser.add_argument("--env_batch_size", type=int, default=8)
  parser.add_argument("--total_ticks", type=int, default=0,
                      help="env batch steps to run (0 = until SIGTERM)")
  parser.add_argument("--policy_poll_ticks", type=int, default=64)
  parser.add_argument("--weights_shm", default="",
                      help="shm variable-container name published by the "
                      "train job (train/variable_container.py)")
  parser.add_argument("--random_ticks", type=int, default=32,
                      help="ticks of uniform-random actions before the "
                      "policy takes over")
  parser.add_argument("--seed", type=int, default=0)
  return parser.parse_args(argv)


def env_specs(env_name: str):
  """(time-step spec, action spec) of one gymnasium env of `env_name`."""
  from agents_tpu_torch.environments import suite_gym

  env = suite_gym.load(env_name)
  specs = env.time_step_spec(), env.action_spec()
  env.close()
  return specs


def build_agent(time_step_spec, action_spec, seed: int = 0, device="cpu"):
  """The job set's SAC agent (the networks' default widths, (256, 256);
  Adam 3e-4 for actor, critics and alpha). The architecture is code shared
  by all jobs; parameters flow through the weight store."""
  import torch

  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_sac_actor_network)

  generator = torch.Generator(device=device)
  generator.manual_seed(seed)

  def adam(params):
    return torch.optim.Adam(params, lr=3e-4)

  tss, asp = time_step_spec, action_spec
  return SacAgent(
      tss, asp,
      make_critic_network(tss.observation, asp, device=device,
                          generator=generator),
      make_sac_actor_network(tss.observation, asp, device=device,
                             generator=generator),
      adam, adam, adam, generator=generator, device=device)


def snapshot_crc32(state_dict) -> int:
  """CRC-32 of a weight snapshot's bytes, in the store's codec order."""
  crc = 0
  for value in state_dict.values():
    crc = zlib.crc32(value.detach().cpu().contiguous().numpy().tobytes(), crc)
  return crc


def run_collector(args, make_env=None, log=print):
  """Collect until `args.total_ticks` ticks (0: until SIGTERM) and return
  the last line's fields. `make_env(env_name)` builds one host env
  (``suite_gym.load`` unless given)."""
  import numpy as np
  import torch

  from agents_tpu_torch.environments import suite_gym
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.policies import policy_saver
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.replay_buffers.host_ingest import IngestClient
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.trajectories import policy_step as ps
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.train.variable_container import VariableContainer
  from agents_tpu_torch.utils import nest_utils

  torch.set_num_threads(1)
  stop = []
  previous_handler = signal.signal(signal.SIGTERM,
                                   lambda *_: stop.append(True))
  make_env = make_env or suite_gym.load
  env = BatchedPyEnvironment([make_env(args.env_name)
                              for _ in range(args.env_batch_size)])
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = build_agent(tss, asp, args.seed, device="cpu")
  pair_spec = array_spec.add_outer_dims_nest(tj.trajectory_spec(tss, asp),
                                             (2,))
  client = IngestClient(args.ring, pair_spec)
  actor = agent.collect_policy_params(agent.init())
  py_policy = JittedPyPolicy(agent.collect_policy, actor, seed=args.seed,
                             device="cpu")
  rng = np.random.RandomState(args.seed)
  weights_vc, last_step, pulls = None, -1, []
  # Each poll until the first snapshot: [tick, what the store held] ("no
  # segment", "empty", or [step, writes] at the first pull).
  first_polls, tick = [], 0

  policy_dir = os.path.join(args.root_dir, "policies", "collect_policy")

  def refresh_from_export() -> bool:
    nonlocal last_step
    if not os.path.exists(os.path.join(policy_dir, policy_saver.MANIFEST)):
      return False                    # the learner has not exported yet
    step = policy_saver.load_manifest(policy_dir)["train_step"]
    if step != last_step:
      policy_saver.load_params(actor, policy_dir)
      py_policy.update_params(actor)
      last_step = step
      pulls.append([step, snapshot_crc32(actor.state_dict())])
    return True

  def refresh_policy() -> bool:
    nonlocal weights_vc, last_step
    if not args.weights_shm:
      return refresh_from_export()
    if weights_vc is None:
      try:
        weights_vc = VariableContainer(args.weights_shm, actor)
      except OSError:
        if not pulls:
          first_polls.append([tick, "no segment"])
        return False                  # the learner has not created it yet
    out = weights_vc.pull()
    if out is None:
      if not pulls:
        first_polls.append([tick, "empty"])
      return False
    params, step = out
    if not pulls:
      first_polls.append([tick, [step, weights_vc.writes()]])
    if step != last_step:
      actor.load_state_dict(params)
      py_policy.update_params(actor)
      last_step = step
      pulls.append([step, snapshot_crc32(params)])
    return True

  def random_action():
    return array_spec.map_spec_nest(
        lambda s: rng.uniform(s.minimum, s.maximum,
                              size=(args.env_batch_size,) + s.shape
                              ).astype(s.dtype), asp)

  have_policy = refresh_policy()
  time_step = env.reset()
  prev_frame = None
  pushed, t0 = 0, time.time()
  try:
    while not stop and (args.total_ticks == 0 or tick < args.total_ticks):
      if tick % args.policy_poll_ticks == 0:
        have_policy = refresh_policy()
      if have_policy and tick >= args.random_ticks:
        action = np.asarray(py_policy.action(time_step).action)
      else:
        action = random_action()
      next_ts = env.step(action)
      frame = tj.from_transition(time_step, ps.PolicyStep(action=action),
                                 next_ts)
      if prev_frame is not None:
        pair = nest_utils.tree_map(
            lambda a, b: np.stack([np.asarray(a), np.asarray(b)], axis=1),
            prev_frame, frame)
        # Blocking push: a full ring means the learner is behind, so wait
        # (bounding policy staleness); the timeout keeps the actor live
        # if the learner dies.
        pushed += client.push_blocking(pair, timeout=10.0)
      prev_frame, time_step = frame, next_ts
      tick += 1
      if tick % 256 == 0:
        log(json.dumps({
            "job": "collect", "ring": args.ring, "tick": tick,
            "pushed_items": pushed, "policy_train_step": last_step,
            "env_steps_per_s": round(
                tick * args.env_batch_size / (time.time() - t0), 1)}))
  finally:
    signal.signal(signal.SIGTERM, previous_handler)
    client.close()
    if weights_vc is not None:
      weights_vc.close()
    env.close()
  done = {"job": "collect", "done": True, "ring": args.ring, "ticks": tick,
          "pushed_items": pushed, "policy_train_step": last_step,
          "pulls": pulls, "first_polls": first_polls}
  log(json.dumps(done))
  return done


def main(argv=None):
  run_collector(parse_args(argv), log=lambda line: print(line, flush=True))


if __name__ == "__main__":
  main()
