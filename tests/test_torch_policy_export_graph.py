"""The exported policy's act call replayed as one CUDA graph per input
signature (the artifact's `loader.py`, `LOADER_SRC` in
`agents_tpu_torch/policies/torch_export.py`): where it engages, what its
signature tells apart, that `refresh_params` reaches a captured graph,
that a returned array is the caller's own, and that calls from several
threads are serialised.

No CUDA graph can be captured on the CPU. There the card's route runs
with a stand-in stream that counts its waits and a stand-in graph whose
replay runs the graph's own copies and program on its buffers, as a
replay does. The tests marked `card` hold the real graph against the
program called op by op on an NVIDIA card, bit for bit, and skip without
one:

    python3 -m pytest tests/test_torch_policy_export_graph.py -m card
"""
import ast
import importlib.util
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from agents_tpu_torch import networks, specs
from agents_tpu_torch.policies import (EpsilonGreedyPolicy, GreedyPolicy,
                                       QPolicy)
from agents_tpu_torch.policies import torch_export
from agents_tpu_torch.policies.policy_saver import PolicySaver
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import profiling

torch.set_num_threads(1)

OBS = specs.ArraySpec((4,), np.float32)
TSS = ts.time_step_spec(OBS)
DISC = specs.BoundedArraySpec((), np.int32, 0, 2)


def _seeded(net, seed):
  """`net` with normal noise from `seed` added to every parameter (the
  factories initialise alike whatever the seed)."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for p in net.parameters():
      p.add_(torch.randn(p.shape, generator=gen).to(p.device))
  return net


def _q(seed, device="cpu"):
  return _seeded(networks.make_q_network(OBS, DISC, fc_layer_params=(8,),
                                         device=device), seed)


def _rnn_q(seed, device="cpu"):
  return _seeded(networks.make_q_rnn_network(
      OBS, DISC, input_fc_layer_params=(8,), lstm_size=8, device=device),
                 seed)


# name: (policy over a network, the network's factory)
POLICIES = {
    "greedy": (lambda net: GreedyPolicy(QPolicy(TSS, DISC, net)), _q),
    "epsilon_greedy": (lambda net: EpsilonGreedyPolicy(
        QPolicy(TSS, DISC, net), 0.5), _q),
    "recurrent": (lambda net: GreedyPolicy(QPolicy(TSS, DISC, net)), _rnn_q),
}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
  """{name: artifact directory} of each policy, exported on the CPU."""
  out = {}
  for name, (make_policy, make_net) in POLICIES.items():
    net = make_net(1)
    out[name] = str(tmp_path_factory.mktemp(name))
    PolicySaver(make_policy(net)).save(out[name], net)
  return out


def _module(directory):
  spec = importlib.util.spec_from_file_location(
      "graph_loader", os.path.join(directory, "loader.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


class _Stream:
  """The policy's CUDA stream on the CPU: it counts the waits."""

  def __init__(self):
    self.waits = 0

  def synchronize(self):
    self.waits += 1


class _StandInGraph:
  """A CUDA graph's replay on the CPU: the graph's copies in, its program
  and its copies out, on its own buffers."""

  def __init__(self, graph, program):
    self.graph, self.program = graph, program
    self.replays = 0

  def replay(self):
    self.graph.run(self.program)
    self.replays += 1


def _graphed(directory, monkeypatch, captures):
  """The artifact's policy on the card's route, on the CPU: a stand-in
  stream, and a capture that installs a stand-in graph (counted in
  `captures`)."""
  module = _module(directory)

  def capture(self, stream, program):
    captures.append(self)
    self.graph = _StandInGraph(self, program)

  monkeypatch.setattr(module._Graph, "capture", capture)
  policy = module.ExportedPolicy(directory, platform="cpu")
  policy._stream = _Stream()
  return policy


def _op_by_op(directory):
  return _module(directory).ExportedPolicy(directory, platform="cpu")


def _observations(n, batch, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal((batch, 4)).astype(np.float32)
          for _ in range(n)]


def _calls(policy, observations, keys=None, state=None):
  """Each observation through `policy.action` (the state threaded from
  call to call where `state` is given); the outputs."""
  out = []
  for i, obs in enumerate(observations):
    key = None if keys is None else keys[i]
    acts, next_state = policy.action([obs], state=state, key_data=key)
    out.append((acts, next_state))
    if state is not None:
      state = next_state
  return out


def _assert_equal(got, want):
  assert len(got) == len(want)
  for (acts, state), (acts_want, state_want) in zip(got, want):
    for x, y in zip(acts + state, acts_want + state_want):
      assert x.dtype == y.dtype and np.array_equal(x, y)


# ----------------------------------------------------------------- CPU


def test_the_cpu_platform_never_graphs(artifacts, monkeypatch):
  """On "cpu" every call is the program op by op: no stream, no capture,
  no signature kept, no `act.replay` span."""
  module = _module(artifacts["greedy"])
  monkeypatch.setattr(module._Graph, "capture", None)
  policy = module.ExportedPolicy(artifacts["greedy"], platform="cpu")
  assert policy._stream is None
  observations = _observations(4, 3)
  with profiling.record() as rec:
    policy.span_hook = profiling.annotate
    got = _calls(policy, observations)
    policy.span_hook = None
  _assert_equal(got, _calls(_op_by_op(artifacts["greedy"]), observations))
  assert policy._seen == {} and policy._graphs == {}
  spans = rec.summary()["spans"]
  assert "act.replay" not in spans and spans["act.program"]["calls"] == 4


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_replayed_calls_equal_op_by_op_calls(artifacts, monkeypatch, name):
  """Six calls of one signature: the first op by op, the second captures
  and replays, the rest replay; actions (and the recurrent policy's
  state, threaded from call to call; the epsilon-greedy policy's draws,
  from a key a call) equal the program called op by op, with one wait a
  replayed call."""
  captures = []
  policy = _graphed(artifacts[name], monkeypatch, captures)
  observations = _observations(6, 3, seed=1)
  keys = [np.asarray([7, i], np.uint32) for i in range(6)]
  state = policy.initial_state(3) if name == "recurrent" else None
  got = _calls(policy, observations, keys, state)
  want = _calls(_op_by_op(artifacts[name]), observations, keys, state)
  _assert_equal(got, want)
  (graph,) = captures
  assert list(policy._graphs.values()) == [graph]
  assert graph.graph.replays == 5 and policy._stream.waits == 5
  if name == "epsilon_greedy":
    assert len({tuple(a[0]) for a, _ in got}) > 1
  if name == "recurrent":
    assert any(np.abs(s).sum() > 0 for s in got[-1][1])


def test_a_new_batch_size_captures_its_own_graph(artifacts, monkeypatch):
  """B=3, B=5, then B=3 again: B=5's first call runs op by op and leaves
  B=3's graph untouched, its second captures a graph of its own; no call
  replays another signature's graph."""
  captures = []
  policy = _graphed(artifacts["greedy"], monkeypatch, captures)
  three, five = _observations(3, 3, seed=2), _observations(3, 5, seed=3)
  got = _calls(policy, three[:2])
  (graph3,) = captures
  got += _calls(policy, five[:1])
  assert captures == [graph3] and graph3.graph.replays == 1
  got += _calls(policy, five[1:])
  graph5 = captures[1]
  assert graph3.graph.replays == 1 and graph5.graph.replays == 2
  got += _calls(policy, three[2:])
  assert graph3.graph.replays == 2 and graph5.graph.replays == 2
  assert len(policy._graphs) == 2 and policy._seen == {}
  assert [a.shape for (a,), _ in got] == [(3,), (3,), (5,), (5,), (5,),
                                          (3,)]
  _assert_equal(got, _calls(_op_by_op(artifacts["greedy"]),
                            three[:2] + five + three[2:]))


def test_a_replay_after_refresh_params_acts_with_the_new_weights(
    artifacts, monkeypatch, tmp_path):
  """`save_checkpoint` with new weights of the same shapes, then
  `refresh_params`: the values are copied into the tensors the captured
  graph reads, the graph is kept, and its next replays act as the program
  op by op with the new weights."""
  export = str(tmp_path / "greedy")
  shutil.copytree(artifacts["greedy"], export)
  captures = []
  policy = _graphed(export, monkeypatch, captures)
  observations = _observations(4, 16, seed=4)
  _calls(policy, observations[:2])
  (graph,) = captures
  tensors = [id(p) for p in policy.params]
  new = _q(9)
  PolicySaver(POLICIES["greedy"][0](new)).save_checkpoint(export, new)
  policy.refresh_params()
  assert [id(p) for p in policy.params] == tensors
  assert list(policy._graphs.values()) == [graph]
  got = _calls(policy, observations[2:])
  assert captures == [graph] and graph.graph.replays == 3
  want = _calls(_op_by_op(export), observations[2:])
  _assert_equal(got, want)
  old = _calls(_op_by_op(artifacts["greedy"]), observations[2:])
  assert any(not np.array_equal(a[0], b[0])
             for (a, _), (b, _) in zip(got, old))


def _linear_program(params, draws, flat_ts, state):
  """A stand-in program of any width: argmax(obs @ W + b)."""
  q = flat_ts[-1] @ params[0] + params[1]
  return [torch.argmax(q, dim=-1).to(torch.int32)], []


def test_refresh_params_with_new_shapes_drops_every_graph(
    artifacts, monkeypatch, tmp_path):
  """New leaves of other shapes (three actions where there were two):
  every graph is dropped; the next call re-warms op by op, the one after
  captures anew, and the replays read the new tensors."""
  export = str(tmp_path / "greedy")
  shutil.copytree(artifacts["greedy"], export)
  rng = np.random.default_rng(5)

  def write(actions):
    w = rng.standard_normal((4, actions)).astype(np.float32)
    b = rng.standard_normal((actions,)).astype(np.float32)
    np.savez(os.path.join(export, torch_export.PARAMS_NPZ), p0=w, p1=b)
    return w, b

  path = os.path.join(export, torch_export.MANIFEST)
  with open(path) as f:
    manifest = json.load(f)
  manifest["num_params_leaves"] = 2
  with open(path, "w") as f:
    json.dump(manifest, f)
  write(2)
  captures = []
  policy = _graphed(export, monkeypatch, captures)
  policy._program = _linear_program
  observations = _observations(6, 32, seed=6)
  _calls(policy, observations[:2])
  assert len(captures) == 1
  w, b = write(3)
  policy.refresh_params()
  assert policy._graphs == {} and policy._seen == {}
  with profiling.record() as rec:
    policy.span_hook = profiling.annotate
    got = _calls(policy, observations[2:])
    policy.span_hook = None
  assert len(captures) == 2 and captures[1].graph.replays == 3
  assert rec.summary()["spans"]["act.replay"]["calls"] == 3
  for obs, ((acts,), _) in zip(observations[2:], got):
    np.testing.assert_array_equal(acts, np.argmax(obs @ w + b, axis=-1))
  assert {int(a) for (acts,), _ in got for a in acts} == {0, 1, 2}


def test_a_returned_array_is_unchanged_by_the_next_call(artifacts,
                                                        monkeypatch):
  """Each replayed call returns copies: they share no memory with the
  graph's pinned output buffers, and later calls leave them as they
  were."""
  policy = _graphed(artifacts["recurrent"], monkeypatch, [])
  observations = _observations(8, 4, seed=7)
  state = policy.initial_state(4)
  kept = []
  for obs in observations:
    acts, state = policy.action([obs], state=state)
    kept.append((acts + state, [x.copy() for x in acts + state]))
  (graph,) = policy._graphs.values()
  buffers = [h.numpy() for h in graph.host_out]
  for returned, copies in kept:
    for x, y in zip(returned, copies):
      assert np.array_equal(x, y)
      assert not any(np.shares_memory(x, h) for h in buffers)
  assert len({a.tobytes() for (a, *_), _ in kept}) > 1


def test_the_span_hook_opens_act_replay_once_a_replayed_call(
    artifacts, monkeypatch):
  """`act.replay` opens inside `act.program` on each replayed call: 3 of 4
  (the first runs op by op); `act.upload` stages, `act.fetch` waits."""
  policy = _graphed(artifacts["greedy"], monkeypatch, [])
  with profiling.record() as rec:
    policy.span_hook = profiling.annotate
    _calls(policy, _observations(4, 2, seed=8))
    policy.span_hook = None
  spans = rec.summary()["spans"]
  assert {name: s["calls"] for name, s in spans.items()} == {
      "act.call": 4, "act.prep": 4, "act.upload": 4, "act.program": 4,
      "act.replay": 3, "act.fetch": 4}
  for span in rec.spans:
    if span.name == "act.replay":
      assert span.parent.name == "act.program"
  assert policy._stream.waits == 3


def test_calls_from_many_threads_each_get_their_own_actions(artifacts,
                                                            monkeypatch):
  """Eight threads calling one policy at once (the interpreter switching
  threads every microsecond) each get the actions of their own
  observations: the lock serialises the calls that share the graph's
  buffers."""
  policy = _graphed(artifacts["greedy"], monkeypatch, [])
  reference = _op_by_op(artifacts["greedy"])
  inputs = [_observations(20, 16, seed=100 + t) for t in range(8)]
  want = [[a for (a,), _ in _calls(reference, obs)] for obs in inputs]
  got, errors = [[] for _ in inputs], []

  def worker(t):
    try:
      for obs in inputs[t]:
        got[t].append(policy.action([obs])[0][0])
    except Exception as e:  # noqa: BLE001 (reported by the test)
      errors.append(e)

  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(inputs))]
    for thread in threads:
      thread.start()
    for thread in threads:
      thread.join(timeout=120)
  finally:
    sys.setswitchinterval(interval)
  assert not any(thread.is_alive() for thread in threads)
  assert not errors, errors
  for g, w in zip(got, want):
    assert len(g) == len(w) and all(np.array_equal(x, y)
                                    for x, y in zip(g, w))
  (graph,) = policy._graphs.values()
  assert graph.graph.replays == 8 * 20 - 1


def test_the_loader_imports_only_numpy_torch_and_the_standard_library():
  """Every import of the loader's source names numpy, torch or a module
  of the standard library (the bare-child tests of
  `test_torch_policy_export.py` run it without the port)."""
  roots = set()
  for node in ast.walk(ast.parse(torch_export.LOADER_SRC)):
    if isinstance(node, ast.Import):
      roots |= {alias.name.split(".")[0] for alias in node.names}
    elif isinstance(node, ast.ImportFrom):
      roots.add(node.module.split(".")[0])
  assert roots and roots <= set(sys.stdlib_module_names) | {"numpy",
                                                             "torch"}
  assert {"numpy", "torch"} <= roots


class _Run:
  """A benchmark run whose stretches (`portbench/spans.py`) are made."""

  def __init__(self, spans):
    self.probes = {"spans": None if spans is None else {
        "recorded": {"summary": {"spans": spans, "counters": {}}}}}


SHARES = {
    "every_call_replays": ({"act.call": 2000, "act.replay": 2000}, 100.0),
    "the_first_call_op_by_op": ({"act.call": 4, "act.replay": 3}, 75.0),
    "a_loader_with_no_graph": ({"act.call": 2000}, None),
    "a_loop_cell": ({"loop.iteration": 200}, None),
    "no_recording": (None, None),
}


@pytest.mark.parametrize("case", sorted(SHARES))
def test_act_graph_share_reads_replays_over_calls(case):
  """`portbench/metrics/act_graph_share.act.py`: the % of the recorded
  stretch's `act.call` entries that opened `act.replay`; None where the
  loader opens no `act.replay` (the parent's), in a loop's cell and where
  nothing was recorded."""
  from portbench import harness
  calls, share = SHARES[case]
  spans = None if calls is None else {
      name: {"calls": n, "total_ns": n, "self_ns": n}
      for name, n in calls.items()}
  assert harness.reader("act_graph_share.act").read(_Run(spans)) == share


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  yield torch.device("cuda")
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = tf32


def _nature_dqn():
  """The pixel example's Nature DQN (84x84x4 uint8 frames, bfloat16
  compute, float32 parameters) on the card, as the act cell exports it."""
  from examples.dqn_pixels_torch import Config, build_loop
  torch.manual_seed(3)
  loop = build_loop(Config(device="cuda", env_batch_size=4,
                           replay_capacity=8, sample_batch_size=4))
  return loop.agent.policy, loop.agent.q_network


def _card_pair(directory):
  """The artifact's policy on "cuda", and a twin that calls the program op
  by op on the card (no stream of its own)."""
  graphed = _module(directory).ExportedPolicy(directory, platform="cuda")
  op_by_op = _module(directory).ExportedPolicy(directory, platform="cuda")
  op_by_op._stream = None
  return graphed, op_by_op


def _frames(n, batch, seed):
  rng = np.random.default_rng(seed)
  return [rng.integers(0, 256, (batch, 84, 84, 4), dtype=np.uint8)
          for _ in range(n)]


def _replays(policy, observations, **kwargs):
  with profiling.record() as rec:
    policy.span_hook = profiling.annotate
    got = _calls(policy, observations, **kwargs)
    policy.span_hook = None
  return got, rec.summary()["spans"].get("act.replay", {}).get("calls", 0)


@pytest.mark.card
@pytest.mark.parametrize("batch", [1, 32])
def test_card_twenty_replayed_calls_equal_the_program_op_by_op(
    card, tmp_path, batch):
  """The Nature DQN's greedy policy: 20 calls on distinct frames, 19 of
  them replays, equal to the program op by op bit for bit."""
  policy, params = _nature_dqn()
  PolicySaver(policy).save(str(tmp_path), params)
  graphed, op_by_op = _card_pair(str(tmp_path))
  frames = _frames(20, batch, seed=batch)
  got, replays = _replays(graphed, frames)
  _assert_equal(got, _calls(op_by_op, frames))
  assert replays == 19


@pytest.mark.card
def test_card_epsilon_greedy_draws_replay_bit_for_bit(card, tmp_path):
  """The Nature DQN's epsilon-greedy policy (draw sites "random_action"
  and "explore"), a key a call, fed alike to both."""
  policy, params = _nature_dqn()
  PolicySaver(EpsilonGreedyPolicy(policy.wrapped, 0.5)).save(
      str(tmp_path), params)
  graphed, op_by_op = _card_pair(str(tmp_path))
  assert graphed.manifest["draw_sites"]
  frames = _frames(20, 8, seed=5)
  keys = [np.asarray([11, i], np.uint32) for i in range(20)]
  got, replays = _replays(graphed, frames, keys=keys)
  _assert_equal(got, _calls(op_by_op, frames, keys=keys))
  assert replays == 19 and len({a[0].tobytes() for a, _ in got}) > 1


@pytest.mark.card
def test_card_recurrent_state_leaves_replay_bit_for_bit(card, tmp_path):
  """A recurrent Q policy's LSTM carry through 20 calls, threaded from
  call to call on each side: actions and states equal bit for bit."""
  net = _rnn_q(4, "cuda")
  PolicySaver(POLICIES["recurrent"][0](net)).save(str(tmp_path), net)
  graphed, op_by_op = _card_pair(str(tmp_path))
  observations = _observations(20, 6, seed=9)
  got, replays = _replays(graphed, observations,
                          state=graphed.initial_state(6))
  _assert_equal(got, _calls(op_by_op, observations,
                            state=op_by_op.initial_state(6)))
  assert replays == 19 and graphed.manifest["state_leaves"]


@pytest.mark.card
def test_card_refresh_params_reaches_the_captured_graph(card, tmp_path):
  """20 calls, new weights by `save_checkpoint` and `refresh_params` on
  both sides, 20 calls more: the graph is kept and replays the new
  weights, equal to the program op by op bit for bit."""
  policy, params = _nature_dqn()
  saver = PolicySaver(policy)
  saver.save(str(tmp_path), params)
  graphed, op_by_op = _card_pair(str(tmp_path))
  frames = _frames(40, 32, seed=12)
  _replays(graphed, frames[:20])
  (graph,) = graphed._graphs.values()
  stale = _calls(op_by_op, frames[20:])
  with torch.no_grad():
    for p in params.parameters():
      p.mul_(-1.5)
  saver.save_checkpoint(str(tmp_path), params)
  graphed.refresh_params()
  op_by_op.refresh_params()
  got, replays = _replays(graphed, frames[20:])
  assert list(graphed._graphs.values()) == [graph] and replays == 20
  _assert_equal(got, _calls(op_by_op, frames[20:]))
  assert any(not np.array_equal(a[0], b[0])
             for (a, _), (b, _) in zip(got, stale))
