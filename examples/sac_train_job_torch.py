"""Distributed SAC with the PyTorch port: the learner job.

Port of ``examples/sac_train_job.py`` with the same flags and defaults
(plus `--device`): this process owns the experience store and the card.
It creates one shared-memory ingest ring per collector
(`replay_buffers/host_ingest.py`, the role of Reverb's server), drains
them, stages the [2, ...] trajectory pairs on the host and inserts them
into the device `UniformReplay` in fixed blocks of `--replay_rows`, then
trains `SacAgent` on [S, 2] samples, `--train_steps_per_call` steps per
call. A Reverb-style rate limiter (`replay_buffers/rate_limiter.py`)
paces it: `MinSize(--min_replay_items)`, or `SampleToInsertRatio` with
`--samples_per_insert`. Collect jobs (`examples/sac_collect_job_torch.py`)
attach to the rings by name.

Weights leave this job every `--export_interval_steps` train steps, and
once at the start, two ways, as in the JAX job: through the shared-memory
`VariableContainer` (`--weights_shm`), and as `PolicySaver` exports under
``root_dir/policies/{collect_policy,greedy_policy}`` (the whole artifact
at a directory's first export in this process, params and train step
only after), which collectors without `--weights_shm` and
``examples/eval_job_torch.py`` poll.

It runs on "cuda" unless `--device` says otherwise. A train call makes no
host sync; the host syncs are the H2D copy of each inserted block, the
D2H copy of each weight push, and the loss read of each log line. Unlike
the JAX job, a `SampleToInsertRatio` learner drains no more frames than
the limiter admits, so the sample-to-insert difference stays inside its
error buffer (the JAX job drains whole rings once an insert is allowed).

Usage (start this first, then N collect jobs):
  python examples/sac_train_job_torch.py --root_dir=/tmp/dist_sac \\
      --rings=sac_ring_0,sac_ring_1 --env_name=Pendulum-v1 \\
      --weights_shm=sac_weights

Smoke (spawns 2 collect jobs, trains 200 steps; the collectors' stdout
is piped and relayed line by line through the learner's one writer, so
their long `done` records never interleave with another process's):
  python examples/sac_train_job_torch.py --smoke [--device cpu]
"""
import argparse
import json
import math
import os
import secrets
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from examples.sac_collect_job_torch import build_agent, env_specs  # noqa: E402


def parse_args(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--root_dir",
                      default=os.path.join(_REPO, "runs", "dist_sac"))
  parser.add_argument("--rings", default="sac_ring_0")
  parser.add_argument("--env_name", default="Pendulum-v1")
  parser.add_argument("--ring_capacity", type=int, default=1 << 15)
  parser.add_argument("--replay_rows", type=int, default=256,
                      help="replay row width = frames added per insert")
  parser.add_argument("--replay_max_length", type=int, default=512)
  parser.add_argument("--sample_batch_size", type=int, default=256)
  parser.add_argument("--train_steps_per_call", type=int, default=8)
  parser.add_argument("--min_replay_items", type=int, default=512)
  parser.add_argument("--samples_per_insert", type=float, default=0.0,
                      help="Reverb SampleToInsertRatio gating: target "
                      "sampled-items per ingested item; 0 = MinSize only")
  parser.add_argument("--sample_insert_error_buffer", type=float,
                      default=0.0, help="ratio slack in samples; 0 = auto")
  parser.add_argument("--total_train_steps", type=int, default=10000)
  parser.add_argument("--export_interval_steps", type=int, default=200)
  parser.add_argument("--weights_shm", default="",
                      help="publish collect-policy weights to this shm "
                      "variable container every export interval "
                      "(collectors pass the same name)")
  parser.add_argument("--force_unlink_shm", action="store_true",
                      help="remove a pre-existing --weights_shm segment "
                      "before creating it (a stale segment from a crashed "
                      "run); without it, a live segment is an error")
  parser.add_argument("--log_interval_steps", type=int, default=400)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--smoke", action="store_true")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  if args.smoke:
    tag = f"{os.getpid()}_{secrets.token_hex(3)}"
    args.total_train_steps = 200
    args.min_replay_items = 64
    args.export_interval_steps = 50
    args.log_interval_steps = 50
    args.rings = f"sac_smoke_{tag}_0,sac_smoke_{tag}_1"
    args.weights_shm = args.weights_shm or f"sac_smoke_weights_{tag}"
  return args


def make_limiter(args):
  """(limiter, samples per train call): `SampleToInsertRatio` when
  `samples_per_insert` > 0, else `MinSize`."""
  from agents_tpu_torch.replay_buffers.rate_limiter import (
      MinSize, SampleToInsertRatio)

  samples_per_chunk = args.train_steps_per_call * args.sample_batch_size
  if args.samples_per_insert <= 0:
    return MinSize(args.min_replay_items), samples_per_chunk
  eb = args.sample_insert_error_buffer or 2.0 * max(
      samples_per_chunk, args.samples_per_insert)
  # The window must cover one whole sample call plus one insert, or the
  # trainer live-locks: can_sample(chunk) needs diff >= min_diff + chunk
  # while inserts stop at diff + spi > max_diff.
  min_eb = 0.5 * (samples_per_chunk + args.samples_per_insert) + 1.0
  if eb < min_eb:
    print(json.dumps({"job": "train", "warning":
                      f"sample_insert_error_buffer {eb} too small for "
                      f"chunked sampling; clamped to {min_eb}"}), flush=True)
    eb = min_eb
  return SampleToInsertRatio(args.samples_per_insert, args.min_replay_items,
                             eb), samples_per_chunk


def insert_allowance(limiter) -> int:
  """Frames the limiter admits now: any number under `MinSize`; under
  `SampleToInsertRatio` the fill to its floor, or as many as keep the
  sample-to-insert difference within ``max_diff``."""
  if not hasattr(limiter, "samples_per_insert"):
    return 1 << 62
  within = int((limiter.max_diff + limiter.samples) //
               limiter.samples_per_insert) - limiter.inserts
  return max(limiter.min_size_to_sample - limiter.inserts, within, 0)


class Learner:
  """The learner of `args` over host envs with `time_step_spec` and
  `action_spec`: rings, device replay, agent, limiter and weight store.
  `seconds` splits its time into drain (and decode), stage (and the H2D
  insert), train calls, weight pushes and policy exports."""

  def __init__(self, args, time_step_spec, action_spec):
    import torch

    from agents_tpu_torch.policies.policy_saver import PolicySaver
    from agents_tpu_torch.replay_buffers import UniformReplay
    from agents_tpu_torch.replay_buffers.host_ingest import IngestServer
    from agents_tpu_torch.specs import array_spec
    from agents_tpu_torch.train.variable_container import VariableContainer
    from agents_tpu_torch.trajectories import trajectory as tj
    from agents_tpu_torch.utils.device import resolve_device
    from agents_tpu_torch.utils.draws import Draws

    self.args = args
    self.device = resolve_device(args.device)
    self.agent = build_agent(time_step_spec, action_spec, args.seed,
                             self.device)
    pair_spec = array_spec.add_outer_dims_nest(
        tj.trajectory_spec(time_step_spec, action_spec), (2,))
    self.servers = [IngestServer(n, pair_spec, capacity=args.ring_capacity)
                    for n in args.rings.split(",")]
    self.replay = UniformReplay(pair_spec, batch_size=args.replay_rows,
                                max_length=args.replay_max_length,
                                device=self.device)
    self.replay_state = self.replay.init()
    self.agent_state = self.agent.init()
    self.draws = Draws(args.seed + 1, self.device)
    self.limiter, self.samples_per_chunk = make_limiter(args)
    self.weights = None
    if args.weights_shm:
      # create refuses to replace a live segment (a duplicate learner would
      # orphan collectors mapped to the old one); a stale one is cleared
      # only on request.
      if args.force_unlink_shm:
        VariableContainer.unlink_name(args.weights_shm)
      self.weights = VariableContainer(
          args.weights_shm, self.collect_params(), create=True)
    policies = os.path.join(args.root_dir, "policies")
    self.exports = (
        (PolicySaver(self.agent.collect_policy),
         os.path.join(policies, "collect_policy"), self.collect_params),
        (PolicySaver(self.agent.policy),
         os.path.join(policies, "greedy_policy"),
         lambda: self.agent.policy_params(self.agent_state)))
    self.staged, self.staged_count = [], 0
    self.total_items, self.train_steps, self.last_export = 0, 0, 0
    self.loss = torch.zeros((), device=self.device)
    self.seconds = {"drain": 0.0, "stage": 0.0, "train": 0.0, "push": 0.0,
                    "export": 0.0}

  def collect_params(self):
    return self.agent.collect_policy_params(self.agent_state)

  def publish(self):
    """Push the collect weights (one D2H copy) at the current step, and
    export the collect and greedy policies at it."""
    if self.weights is not None:
      t0 = time.perf_counter()
      self.weights.push(self.collect_params(), self.train_steps)
      self.seconds["push"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    for saver, directory, params in self.exports:
      saver.publish(directory, params(), self.train_steps)
    self.seconds["export"] += time.perf_counter() - t0

  def drain(self) -> list:
    """Drain the rings as far as the limiter admits; returns the decoded
    numpy blocks (also staged for `flush`)."""
    t0 = time.perf_counter()
    allowance = insert_allowance(self.limiter)
    blocks = []
    for server in self.servers:
      if allowance <= 0:
        break
      out = server.drain(max_frames=min(4096, allowance))
      if out is not None:
        n = out.step_type.shape[0]
        blocks.append(out)
        allowance -= n
    got = sum(b.step_type.shape[0] for b in blocks)
    if got:
      self.staged += blocks
      self.staged_count += got
      self.limiter.record_insert(got)
      self.total_items += got
    self.seconds["drain"] += time.perf_counter() - t0
    return blocks

  def flush(self):
    """Insert the staged frames into the device replay in whole blocks of
    `replay_rows` (one H2D copy each); the rest stays staged."""
    import numpy as np
    import torch

    from agents_tpu_torch.utils import nest_utils

    rows = self.args.replay_rows
    if self.staged_count < rows:
      return
    t0 = time.perf_counter()
    flat = nest_utils.tree_map(lambda *xs: np.concatenate(xs, axis=0),
                               *self.staged)
    for i in range(self.staged_count // rows):
      block = nest_utils.tree_map(
          lambda x: torch.from_numpy(x[i * rows:(i + 1) * rows]).to(
              self.device), flat)
      self.replay_state = self.replay.add_batch(self.replay_state, block)
    done = self.staged_count // rows * rows
    self.staged = [nest_utils.tree_map(lambda x: x[done:], flat)]
    self.staged_count -= done
    self.seconds["stage"] += time.perf_counter() - t0

  def train_call(self):
    """`train_steps_per_call` SAC steps on [S, 2] samples; no host sync."""
    t0 = time.perf_counter()
    self.limiter.record_sample(self.samples_per_chunk)
    for _ in range(self.args.train_steps_per_call):
      experience, _ = self.replay.sample(self.replay_state, self.draws,
                                         self.args.sample_batch_size)
      self.agent_state, info = self.agent.train(self.agent_state, experience)
    self.loss = info.loss
    self.train_steps += self.args.train_steps_per_call
    self.seconds["train"] += time.perf_counter() - t0

  def step(self):
    """Drain and insert while allowed, wait for the limiter to admit one
    train call, train, and publish the weights when an interval is due."""
    self.drain()
    self.flush()
    while (not self.limiter.can_sample(self.samples_per_chunk)
           or self.replay_state.count == 0):
      if not self.drain():
        time.sleep(0.01)
      self.flush()
    self.train_call()
    if self.train_steps - self.last_export >= self.args.export_interval_steps:
      self.publish()
      self.last_export = self.train_steps

  def dropped(self) -> int:
    return sum(s.dropped() for s in self.servers)

  def close(self):
    for s in self.servers:
      s.close()
    if self.weights is not None:
      self.weights.close()
      self.weights.unlink()


def line_logger(stream=None):
  """A `log(line)` that writes each line whole, with its newline, in one
  locked write to `stream` (stdout unless given), from any thread."""
  lock = threading.Lock()

  def log(line):
    with lock:
      out = stream or sys.stdout
      out.write(line + "\n")
      out.flush()
  return log


def relay_lines(proc, log):
  """A started thread that passes each line of `proc`'s piped stdout to
  `log` whole: the children's long records then reach the job's stdout
  through one writer, never interleaved with another process's."""
  def relay():
    for line in proc.stdout:
      log(line.rstrip("\n"))

  thread = threading.Thread(target=relay, daemon=True)
  thread.start()
  return thread


def main(argv=None):
  args = parse_args(argv)
  log = line_logger()
  learner = Learner(args, *env_specs(args.env_name))
  collectors, relays = [], []
  try:
    if args.smoke:
      for ring in args.rings.split(","):
        collectors.append(subprocess.Popen([
            sys.executable,
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "sac_collect_job_torch.py"),
            f"--root_dir={args.root_dir}", f"--ring={ring}",
            f"--env_name={args.env_name}", "--env_batch_size=4",
            "--total_ticks=0", "--random_ticks=8", "--policy_poll_ticks=16",
            f"--weights_shm={args.weights_shm}"],
            stdout=subprocess.PIPE, text=True))
        relays.append(relay_lines(collectors[-1], log))
    # The initial weights at once, so collectors leave random play
    # without waiting for the first interval.
    learner.publish()
    log(json.dumps({"job": "train",
                    "waiting_for_items": args.min_replay_items}))
    t0 = time.time()
    while learner.train_steps < args.total_train_steps:
      learner.step()
      if (learner.train_steps % args.log_interval_steps
          < args.train_steps_per_call):
        log(json.dumps({
            "job": "train", "train_steps": learner.train_steps,
            "items_ingested": learner.total_items,
            "dropped": learner.dropped(), "loss": float(learner.loss),
            "train_steps_per_s": round(
                learner.train_steps / (time.time() - t0), 1)}))
    loss = float(learner.loss)
  finally:
    for p in collectors:
      p.terminate()
    for p in collectors:
      try:
        p.wait(timeout=30)
      except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    for thread in relays:
      thread.join(timeout=30)
    learner.close()
  log(json.dumps({"job": "train", "done": True,
                  "train_steps": learner.train_steps,
                  "items_ingested": learner.total_items,
                  "final_loss": loss, "seconds": learner.seconds}))
  if not math.isfinite(loss):
    raise SystemExit("the final loss is not finite")


if __name__ == "__main__":
  main()
