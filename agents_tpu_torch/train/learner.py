"""Learner: the host shell around a training loop.

Port of ``agents_tpu/train/learner.py``. The loop does the work
(`FusedTrainLoop`, `OnPolicyTrainLoop`, ...); the Learner adds the shell:
the root_dir layout (``train/checkpoints``, ``policies``), restore from
the newest checkpoint at start, a checkpoint every `checkpoint_interval`
steps through the port's `Checkpointer`, triggers, and summaries (loss,
``loss_extra/*``, ``collect/*`` and ``steps_per_sec``).

The JAX Learner jits its train function; the port's loops run eagerly, so
`run` calls the loop as it is. The one host read of a `run` call is the
last loss; summaries read the loss extras and metric results, at their
own interval only.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from agents_tpu_torch.train.checkpointer import Checkpointer
from agents_tpu_torch.train.triggers import (IntervalTrigger,
                                             StepPerSecondTracker)

TRAIN_DIR = "train"
POLICY_SAVED_MODEL_DIR = "policies"
GREEDY_POLICY_SAVED_MODEL_DIR = "greedy_policy"
COLLECT_POLICY_SAVED_MODEL_DIR = "collect_policy"


def _leaves_with_paths(nest, path=()):
  """(path tuple, tensor) of a nest of dataclasses, dicts, tuples and
  lists, as ``jax.tree_util.tree_flatten_with_path`` names them."""
  if isinstance(nest, torch.Tensor):
    return [(path, nest)]
  if dataclasses.is_dataclass(nest) and not isinstance(nest, type):
    return [leaf for f in dataclasses.fields(nest)
            for leaf in _leaves_with_paths(getattr(nest, f.name),
                                           path + (f.name,))]
  if isinstance(nest, dict):
    return [leaf for k in sorted(nest)
            for leaf in _leaves_with_paths(nest[k], path + (k,))]
  if isinstance(nest, (tuple, list)):
    return [leaf for i, v in enumerate(nest)
            for leaf in _leaves_with_paths(v, path + (i,))]
  return []


class Learner:
  """Args:
    root_dir: experiment directory (checkpoints under root/train).
    loop: an object with ``run(state, n) -> (state, losses)`` (and
      ``run_with_info``, ``results`` and ``metrics`` where it has them),
      or pass `train_fn`.
    initial_state: the loop state (restored in place from the newest
      checkpoint when there is one).
    train_fn: in place of the loop's run, ``(state, n) -> (state,
      losses)``.
    triggers: IntervalTrigger-likes called with the global step after
      each `run`.
    checkpoint_interval: steps between checkpoints; <= 0 disables them.
    steps_per_run_call: gradient steps per iteration (a loop that takes
      several train steps an iteration); `global_step`, and with it the
      checkpoint and summary triggers, advances by ``iterations *
      steps_per_run_call`` each `run`.
  """

  def __init__(self, root_dir: str, loop=None, initial_state=None,
               train_fn: Optional[Callable] = None,
               triggers: Sequence = (),
               checkpoint_interval: int = 100_000,
               steps_per_run_call: int = 1,
               summary_writer=None,
               summary_interval: int = 100,
               extra_summary_fn: Optional[Callable] = None):
    self.root_dir = root_dir
    self.train_dir = os.path.join(root_dir, TRAIN_DIR)
    os.makedirs(self.train_dir, exist_ok=True)
    self.loop = loop
    # The loop's info-returning path, so loss extras reach the summaries.
    self._with_info = train_fn is None and hasattr(loop, "run_with_info")
    if train_fn is not None:
      self._train_fn = train_fn
    else:
      self._train_fn = loop.run_with_info if self._with_info else loop.run
    self.state = initial_state
    self.triggers = list(triggers)
    self.steps_per_run_call = int(steps_per_run_call)
    self.summary_writer = summary_writer
    self.summary_interval = summary_interval
    self.extra_summary_fn = extra_summary_fn
    self.global_step = 0
    self._tracker = StepPerSecondTracker()
    self._summary_trigger = IntervalTrigger(
        max(summary_interval, 1), self._write_summaries)
    self._last_info = None

    if checkpoint_interval <= 0:
      logging.warning(
          "Checkpointing disabled: if the pipeline gets preempted, all "
          "previous progress is lost.")
      self.checkpointer = None
      self._ckpt_trigger = None
    else:
      self.checkpointer = Checkpointer(
          os.path.join(self.train_dir, "checkpoints"))
      self.state = self.checkpointer.initialize_or_restore(self.state)
      latest = self.checkpointer.latest_step()
      if latest:
        self.global_step = latest
        # Re-baseline the tracker: from step 0, the first steps_per_sec
        # after a resume would report (restored step) / (process age).
        self._tracker.restart(self.global_step)
      self._ckpt_trigger = IntervalTrigger(
          checkpoint_interval,
          lambda: self.checkpointer.save(self.global_step, self.state))

  def run(self, iterations: int = 1) -> float:
    """Run `iterations` loop iterations; returns the last loss."""
    self.state, out = self._train_fn(self.state, iterations)
    self.global_step += iterations * self.steps_per_run_call
    if self._with_info:
      self._last_info = out
      losses = out.loss
    else:
      self._last_info = None
      losses = out
    loss = float(torch.as_tensor(losses).reshape(-1)[-1])
    self._last_loss = loss
    for trig in self.triggers:
      trig(self.global_step)
    if self._ckpt_trigger is not None:
      self._ckpt_trigger(self.global_step)
    if self.summary_writer is not None:
      self._summary_trigger(self.global_step)
    return loss

  def _write_summaries(self):
    """Loss, loss extras (the last iteration's, averaged), collect
    metrics and steps/s at the global step."""
    w = self.summary_writer
    step = self.global_step
    w.scalar("loss", self._last_loss, step)
    if self._last_info is not None:
      for path, leaf in _leaves_with_paths(self._last_info.extra):
        name = "/".join(["loss_extra"] + [str(p) for p in path])
        w.scalar(name, float(leaf[-1].float().mean()), step)
    if self.loop is not None and hasattr(self.loop, "results"):
      # A count vector (ChosenActionHistogram) becomes a histogram, routed
      # by the metric's declared result_kind, never by its name; other
      # vectors are written per component, so no metric is dropped.
      kinds = {m.name: getattr(m, "result_kind", "scalar")
               for m in getattr(self.loop, "metrics", ())}
      for name, val in self.loop.results(self.state).items():
        v = np.asarray(torch.as_tensor(val).detach().cpu())
        if v.ndim == 0:
          w.scalar("collect/" + name, float(v), step)
        elif (v.ndim == 1 and kinds.get(name) == "counts"
              and hasattr(w, "histogram_from_counts")):
          w.histogram_from_counts("collect/" + name, v, step)
        elif v.ndim == 1:
          for i, comp in enumerate(v):
            w.scalar(f"collect/{name}/{i}", float(comp), step)
    sps = self._tracker.steps_per_second(step)
    self._tracker.restart(step)
    w.scalar("steps_per_sec", sps, step)
    if self.extra_summary_fn is not None:
      for name, val in self.extra_summary_fn(self.state).items():
        w.scalar(name, float(val), step)

  def steps_per_second(self) -> float:
    sps = self._tracker.steps_per_second(self.global_step)
    self._tracker.restart(self.global_step)
    return sps

  def checkpoint(self, force: bool = True):
    if self.checkpointer:
      self.checkpointer.save(self.global_step, self.state, force=force)


class JsonlSummaryWriter:
  """A metric logger: one JSON line per scalar, tail-able and
  machine-readable."""

  def __init__(self, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    self._f = open(path, "a")

  def scalar(self, name: str, value: float, step: int):
    self._f.write(json.dumps(
        {"step": int(step), name: float(value), "t": time.time()}) + "\n")
    self._f.flush()

  def histogram_from_counts(self, name: str, counts, step: int,
                            limits=None):
    rec = {"step": int(step), name: [float(c) for c in np.asarray(counts)],
           "t": time.time()}
    if limits is not None:
      rec[name + "/limits"] = [float(x) for x in np.asarray(limits)]
    self._f.write(json.dumps(rec) + "\n")
    self._f.flush()

  def close(self):
    self._f.close()
