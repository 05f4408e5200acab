"""Process-parallel host environments.

Port of ``agents_tpu/environments/parallel_py_environment.py``: each env
lives in a subprocess behind a pipe, with promise-style asynchronous
calls; an exception in a child is raised in the parent with the child's
traceback.

The start method: fork keeps closures working (nothing is pickled), but a
fork of a process whose CUDA runtime is up clones its driver threads in
whatever lock they hold, and the child can deadlock. So once
``torch.cuda.is_initialized()``, a constructor that pickles is started
with spawn; one that does not falls back to fork with a warning (build
parallel envs before touching the card to avoid both).
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import pickle
import sys
import traceback
import warnings
from typing import Callable, Optional, Sequence

import numpy as np

from agents_tpu_torch.environments.py_environment import PyEnvironment
from agents_tpu_torch.utils import nest_utils

_CALL = "call"
_ACCESS = "access"
_RESULT = "result"
_EXCEPTION = "exception"
_CLOSE = "close"


def _worker(pipe, env_ctor):
  """The child's loop: build the env, then serve calls until close."""
  try:
    env = env_ctor()
    while True:
      try:
        message, payload = pipe.recv()
      except (EOFError, KeyboardInterrupt):
        break
      if message == _ACCESS:
        pipe.send((_RESULT, getattr(env, payload)))
      elif message == _CALL:
        name, args, kwargs = payload
        pipe.send((_RESULT, getattr(env, name)(*args, **kwargs)))
      elif message == _CLOSE:
        env.close()
        break
      else:
        raise KeyError(f"Unknown message {message}")
  except Exception:  # pylint: disable=broad-except
    stacktrace = "".join(traceback.format_exception(*sys.exc_info()))
    try:
      pipe.send((_EXCEPTION, stacktrace))
    except Exception:  # pylint: disable=broad-except
      pass
  finally:
    try:
      pipe.close()
    except Exception:  # pylint: disable=broad-except
      pass


def choose_start_method(env_ctor) -> str:
  """spawn on Windows, and once CUDA is initialized for a picklable
  `env_ctor`; fork otherwise."""
  if sys.platform == "win32":
    return "spawn"
  import torch
  if not torch.cuda.is_initialized():
    return "fork"
  try:
    pickle.dumps(env_ctor)
  except Exception:  # pylint: disable=broad-except
    warnings.warn(
        "ParallelPyEnvironment: CUDA is already initialized and env_ctor is "
        "not picklable, so the worker is forked and may deadlock if a CUDA "
        "thread held a lock. Build parallel envs before using the card, or "
        "pass a picklable ctor.", stacklevel=3)
    return "fork"
  return "spawn"


class ProcessPyEnvironment:
  """One env in a subprocess."""

  def __init__(self, env_ctor: Callable[[], PyEnvironment],
               start_method: Optional[str] = None):
    self._ctor = env_ctor
    self._conn = None
    self._process = None
    self._start_method = start_method

  @property
  def start_method(self) -> Optional[str]:
    return self._start_method

  def start(self):
    if self._start_method is None:
      self._start_method = choose_start_method(self._ctor)
    ctx = mp.get_context(self._start_method)
    self._conn, child_conn = ctx.Pipe()
    self._process = ctx.Process(target=_worker, args=(child_conn, self._ctor),
                                daemon=True)
    self._process.start()
    child_conn.close()
    atexit.register(self.close)
    return self

  def _receive(self):
    message, payload = self._conn.recv()
    if message == _EXCEPTION:
      raise RuntimeError(
          f"Exception in ParallelPyEnvironment worker:\n{payload}")
    assert message == _RESULT, message
    return payload

  def access(self, name):
    self._conn.send((_ACCESS, name))
    return self._receive()

  def call(self, name, *args, **kwargs):
    """Sends the call; returns a promise that receives its result."""
    self._conn.send((_CALL, (name, args, kwargs)))
    return self._receive

  def call_sync(self, name, *args, **kwargs):
    return self.call(name, *args, **kwargs)()

  def step(self, action, blocking=True):
    promise = self.call("step", action)
    return promise() if blocking else promise

  def reset(self, blocking=True):
    promise = self.call("reset")
    return promise() if blocking else promise

  def close(self):
    if self._conn is not None:
      try:
        self._conn.send((_CLOSE, None))
        self._conn.close()
      except (IOError, OSError):
        pass
      self._conn = None
    if self._process is not None:
      self._process.join(3)
      if self._process.is_alive():
        self._process.terminate()
      self._process = None

  @property
  def alive(self) -> bool:
    return self._process is not None and self._process.is_alive()


class ParallelPyEnvironment(PyEnvironment):
  """N envs in N subprocesses, stepped as one batch. With `blocking` the
  workers step one after another (deterministic interleaving, easier
  debugging); otherwise their steps overlap through promises."""

  def __init__(self, env_ctors: Sequence[Callable[[], PyEnvironment]],
               start_serially: bool = True, blocking: bool = False,
               start_method: Optional[str] = None):
    super().__init__()
    # start() only starts the worker; readiness is awaited at the first
    # call, so serial and parallel start are the same here.
    del start_serially
    self._blocking = blocking
    self._procs = [ProcessPyEnvironment(c, start_method) for c in env_ctors]
    for p in self._procs:
      p.start()
    self._observation_spec = self._procs[0].call_sync("observation_spec")
    self._action_spec = self._procs[0].call_sync("action_spec")
    self._reward_spec = self._procs[0].call_sync("reward_spec")

  @property
  def batched(self):
    return True

  @property
  def batch_size(self):
    return len(self._procs)

  @property
  def start_methods(self):
    return [p.start_method for p in self._procs]

  def observation_spec(self):
    return self._observation_spec

  def action_spec(self):
    return self._action_spec

  def reward_spec(self):
    return self._reward_spec

  def _gather(self, promises_or_steps):
    if self._blocking:
      return nest_utils.stack_nested_arrays(promises_or_steps)
    return nest_utils.stack_nested_arrays([pr() for pr in promises_or_steps])

  def _reset(self):
    return self._gather([p.reset(blocking=self._blocking)
                         for p in self._procs])

  def _step(self, actions):
    rows = [nest_utils.tree_map(lambda x: np.asarray(x)[i], actions)
            for i in range(len(self._procs))]
    return self._gather([p.step(a, blocking=self._blocking)
                         for p, a in zip(self._procs, rows)])

  def step(self, action):
    """Every row steps; each worker's env auto-resets on its own."""
    if self._current_time_step is None:
      return self.reset()
    self._current_time_step = self._step(action)
    return self._current_time_step

  def seed(self, seeds):
    """One seed per worker; a scalar seed s gives s, s + 1, ..."""
    if np.ndim(seeds) == 0:
      seeds = int(seeds) + np.arange(len(self._procs))
    seeds = np.asarray(seeds)
    if seeds.shape != (len(self._procs),):
      raise ValueError(f"need {len(self._procs)} seeds, got {seeds.shape}")
    promises = [p.call("seed", int(s)) for p, s in zip(self._procs, seeds)]
    return [pr() for pr in promises]

  def close(self):
    for p in self._procs:
      p.close()

  @property
  def workers_alive(self) -> int:
    return sum(p.alive for p in self._procs)
