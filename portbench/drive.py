"""The general traffic generator: one driver per kind of traffic file.

``fused_loop``  a closed training loop: the configuration's fused
                collect-and-train iteration, run back to back. Keys:
                ``follow_train_steps`` (steps the reference follows),
                ``fill_ring`` (true: set-up collects until the ring holds
                its capacity when the window opens, so the window samples
                from a full ring and wraps it), ``warmup_iterations``,
                ``profile_iterations`` (the traced sub-window). Where the
                program's adapter names a train step that updates a
                target network (`target_update_step`), set-up runs
                through the first such step past the followed ones and
                keeps the leaves around it for the reference.
``act``         one client's closed loop of act calls on the exported
                greedy policy, observations drawn from a host pool. Keys:
                ``batch``, ``pool`` (observations in the pool),
                ``warmup_calls``, ``profile_calls``, ``check_calls``
                (calls judged, drawn from the seed after the window).

Each driver makes the cell's state (set-up, counted in `setup_s`), runs
the measured window, profiles a sub-window after it where the run is
traced or the cell reads an end-to-end metric from the device's trace,
reads those metrics, frees the program's state and works out the numbers
that decide `correct`.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import devtrace, inputs, judge


def _clone(tensors: dict) -> dict:
  return {k: v.detach().clone() for k, v in tensors.items()}


def follow_program(loop, state, adapter, hp, train_steps: int,
                   iterations: int):
  """Run `iterations` iterations through the loop's own `run`, keeping what
  the program produced over its first `train_steps` train steps."""
  agent = loop.agent
  original = agent.train
  produced = {"losses": [], "td_error": [], "before": _clone(
      adapter.state_leaves(hp, state.agent_state))}
  calls = [0]

  def train(agent_state, experience, weights=None):
    new_state, info = original(agent_state, experience, weights=weights)
    k = calls[0]
    calls[0] += 1
    if k < train_steps:
      produced["losses"].append(_clone(adapter.losses(info)))
      rows = adapter.row_errors(info)
      if rows is not None:
        produced["td_error"].append(rows.detach().clone())
    if k == 0:
      produced["grads"] = _clone(adapter.first_grads(hp, new_state))
    if k + 1 == train_steps:
      produced["after"] = _clone(adapter.state_leaves(hp, new_state))
    return new_state, info

  with _patched(agent, "train", train):
    state, _ = loop.run(state, iterations)
  if calls[0] < train_steps:
    raise RuntimeError(f"{calls[0]} train steps, {train_steps} followed")
  produced["losses"] = [{k: float(v) for k, v in step.items()}
                        for step in produced["losses"]]
  replay = state.replay_state
  names = adapter.EXACT_RING + ("action",)
  produced["ring"] = {k: getattr(replay.storage, k)[:replay.count].clone()
                      for k in dict.fromkeys(names)}
  produced["actions"] = produced["ring"]["action"]
  return state, produced


@contextlib.contextmanager
def _patched(obj, attr, value):
  """`obj.attr` is `value` inside the block, as before it after."""
  own = attr in vars(obj)
  before = vars(obj).get(attr)
  setattr(obj, attr, value)
  try:
    yield
  finally:
    if own:
      setattr(obj, attr, before)
    else:
      delattr(obj, attr)


@contextlib.contextmanager
def layer_spans(loop):
  """The benchmark's own spans around the loop's calls into its layers:
  the collect driver, the replay's sample and the agent's train step."""
  from torch.profiler import record_function

  targets = ((loop.driver, "run", "portbench.collect"),
             (loop.replay, "sample", "portbench.replay_sample"),
             (loop.agent, "train", "portbench.train"))

  def wrap(fn, name):
    def wrapped(*args, **kwargs):
      with record_function(name):
        return fn(*args, **kwargs)
    return wrapped

  with contextlib.ExitStack() as stack:
    for obj, attr, name in targets:
      stack.enter_context(_patched(obj, attr, wrap(getattr(obj, attr), name)))
    yield


def _print_pace(run, unit, timed_units):
  p = run.profile
  print(f"portbench: profiled {p['window_s'] * 1e3 / p['units']:.4f} ms per "
        f"{unit}, timed {run.window['seconds'] * 1e3 / timed_units:.4f}",
        file=sys.stderr)


def _profile_loop(run, loop, state, draws):
  """The profiled sub-window, where the run is traced or the cell reads an
  end-to-end metric from the device's trace; then those readers, and when
  traced the per-layer readers, which may time the loop's layers on the
  state the window left."""
  from portbench import harness

  if not (run.trace or harness.profiles_every_run(run)):
    return
  box = {"state": state}
  iterations = run.traffic["profile_iterations"]

  def traced():
    box["state"], _ = loop.run(box["state"], iterations)

  with layer_spans(loop):
    run.profile = devtrace.profile_window(traced, run.sync)
  run.profile["units"] = iterations
  _print_pace(run, "iteration", run.window["iterations"])
  harness.read_end_to_end(run)
  if run.trace:
    run.probes.update(loop=loop, box=box, draws=draws)
    run.layer_metrics = harness.read_layers(run)


def target_update(adapter, hp, agent_state, per_iteration: int):
  """(the first train step past `agent_state` that updates the target
  network, the iterations that reach it), or (None, 0) where the
  adapter names no such step (`target_update_step`)."""
  step_of = getattr(adapter, "target_update_step", None)
  target = step_of(hp, agent_state) if step_of else None
  if target is None:
    return None, 0
  return target, -(-(target - adapter.train_step(agent_state))
                   // per_iteration)


def follow_target_update(loop, state, adapter, hp, target: int,
                         iterations: int):
  """Run `iterations` iterations through the loop's own `run`, keeping
  every leaf just before and just after train step `target`."""
  agent, kept = loop.agent, {}
  original = agent.train

  def train(agent_state, experience, weights=None):
    updates = adapter.train_step(agent_state) + 1 == target
    if updates:
      kept["before"] = _clone(adapter.state_leaves(hp, agent_state))
    new_state, info = original(agent_state, experience, weights=weights)
    if updates:
      kept["after"] = _clone(adapter.state_leaves(hp, new_state))
    return new_state, info

  with _patched(agent, "train", train):
    state, _ = loop.run(state, iterations)
  if set(kept) != {"before", "after"}:
    raise RuntimeError(f"train step {target} was not reached")
  return state, kept


def judge_sample(loop, state, adapter, draws):
  """One more iteration through the loop's own `run`, keeping the windows
  its first train step was handed and the draws that picked them; returns
  (state, sample numbers) of those windows against the ring."""
  draws.records = collections.defaultdict(list)
  draws.recording = True
  kept = {}
  original = loop.agent.train
  names = tuple(dict.fromkeys(adapter.EXACT_RING + ("action",)))

  def train(agent_state, experience, weights=None):
    if not kept:
      kept.update({k: getattr(experience, k).clone() for k in names})
    return original(agent_state, experience, weights=weights)

  with _patched(loop.agent, "train", train):
    state, _ = loop.run(state, 1)
  draws.recording = False
  replay = state.replay_state
  storage = {k: getattr(replay.storage, k) for k in names}
  numbers = judge.sample_numbers(storage, replay.count, loop.replay.capacity,
                                 draws.records, kept)
  return state, numbers


def fused_loop(run):
  traffic, adapter = run.traffic, run.adapter
  loop, hp = adapter.build(run.config, run.device)
  run.hp, run.model = hp, adapter.model(hp)
  weights = inputs.make_weights(run.seed, adapter.leaves(hp), run.device)
  adapter.load_weights(loop, hp, weights)
  if run.plant:
    run.plant(loop)
  draws = inputs.SeededDraws(run.seed, run.device)
  state = loop.init(draws=draws,
                    initial_collect_steps=hp["initial_collect_steps"])
  state = adapter.prepare(state, draws)
  follow = traffic["follow_train_steps"]
  per_iteration = run.model["train_steps_per_iteration"]
  iterations = -(-follow // per_iteration)
  state, produced = follow_program(loop, state, adapter, hp, follow,
                                   iterations)
  draws.recording = False
  records = draws.records
  warmup = traffic["warmup_iterations"]
  target, to_target = target_update(adapter, hp, state.agent_state,
                                    per_iteration)
  if traffic.get("fill_ring"):
    to_come = loop.collect_steps * (to_target + warmup)
    missing = loop.replay.capacity - state.replay_state.count - to_come
    if missing > 0:
      state = loop.initial_collect(state, missing)
  produced["target_update"] = {}
  if target is not None:
    state, produced["target_update"] = follow_target_update(
        loop, state, adapter, hp, target, to_target)
  state, _ = loop.run(state, warmup)
  run.sync()
  gc.freeze()
  run.setup_s = time.perf_counter() - run.t_start
  print(f"portbench: the ring holds {min(state.replay_state.count, loop.replay.capacity)}"
        f" of {loop.replay.capacity} frames per row as the window opens",
        file=sys.stderr)

  losses, n = [], 0
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < run.seconds:
    state, loss = loop.run(state, 1)
    losses.append(loss)
    n += 1
  run.sync()
  window_s = time.perf_counter() - t0
  if run.on_card:
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
  run.attempted = n
  run.failed = int((~torch.isfinite(torch.cat(losses))).sum())
  run.window = {
      "seconds": window_s, "iterations": n, "setup_s": run.setup_s,
      "env_steps_per_s": n * run.model["env_steps_per_iteration"] / window_s,
      "train_steps_per_s":
          n * run.model["train_steps_per_iteration"] / window_s}
  del losses
  state, sampled = judge_sample(loop, state, adapter, draws)

  _profile_loop(run, loop, state, draws)
  del loop, state
  run.free_program()

  run.judged = {"weights": weights, "records": records,
                "produced": produced,
                "follow_args": (hp["initial_collect_steps"], iterations,
                                follow)}
  run.numbers = judge.training_numbers(adapter, hp, weights, records,
                                       produced, run.judged["follow_args"])
  run.numbers.update(sampled)


def _load_loader(export_dir):
  path = os.path.join(export_dir, "loader.py")
  spec = importlib.util.spec_from_file_location("portbench_policy_loader",
                                                path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _profile_act(run, exported, pool):
  """The profiled sub-window of act calls, as `_profile_loop` has it."""
  from portbench import harness

  if not (run.trace or harness.profiles_every_run(run)):
    return
  calls = run.traffic["profile_calls"]

  def traced():
    for i in range(calls):
      exported.action([pool[i % len(pool)]])

  run.profile = devtrace.profile_window(traced, run.sync)
  run.profile["units"] = calls
  _print_pace(run, "call", run.window["calls"])
  harness.read_end_to_end(run)
  if run.trace:
    run.probes.update(exported=exported, pool=pool)
    run.layer_metrics = harness.read_layers(run)


def act(run):
  from agents_tpu_torch.policies.policy_saver import PolicySaver

  traffic, adapter = run.traffic, run.adapter
  loop, hp = adapter.build(run.config, run.device)
  run.hp, run.model = hp, adapter.model(hp)
  weights = inputs.make_weights(run.seed, adapter.leaves(hp), run.device)
  adapter.load_weights(loop, hp, weights)
  policy, params = adapter.policy(loop)
  export_dir = tempfile.mkdtemp(prefix="portbench_policy_")
  try:
    PolicySaver(policy).save(export_dir, params)
    exported = _load_loader(export_dir).ExportedPolicy(
        export_dir, platform=run.device.type)
    del loop, policy, params
    if run.plant:
      exported = run.plant(exported)
    batch = traffic["batch"]
    shape = (hp["pixels_size"], hp["pixels_size"], hp["pixels_frames"])
    pool = inputs.observation_pool(run.seed, traffic["pool"] * batch, shape)
    pool = pool.reshape((traffic["pool"], batch) + shape)
    size = len(pool)
    for i in range(traffic["warmup_calls"]):
      exported.action([pool[i % size]])
    run.sync()
    gc.freeze()
    run.setup_s = time.perf_counter() - run.t_start

    actions, n = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
      out, _ = exported.action([pool[n % size]])
      actions.append(out[0])
      n += 1
    window_s = time.perf_counter() - t0
    if run.on_card:
      run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    actions = np.stack(actions)                       # [calls, batch]
    num_actions = hp["pixels_actions"]
    run.attempted = n
    run.failed = int(((actions < 0) | (actions >= num_actions)).any(-1).sum())
    run.window = {"seconds": window_s, "calls": n, "setup_s": run.setup_s,
                  "act_latency_mean_ms": window_s * 1e3 / n}

    _profile_act(run, exported, pool)
    del exported
    run.free_program()

    rng = np.random.default_rng(inputs.stream_seed(run.seed, "check"))
    picked = rng.choice(n, size=min(n, traffic["check_calls"]), replace=False)
    obs = torch.from_numpy(pool[picked % size].reshape((-1,) + shape))
    run.judged = {"weights": weights, "obs": obs.to(run.device)}
    run.numbers = judge.act_numbers(
        adapter, hp, weights, run.judged["obs"],
        torch.from_numpy(actions[picked].reshape(-1)))
  finally:
    shutil.rmtree(export_dir, ignore_errors=True)


KINDS = {"fused_loop": fused_loop, "act": act}
