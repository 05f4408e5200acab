"""The port's own spans and counters (`utils/profiling.py`) on the CPU: the
fused loop's iteration, collect and sample, the replay insert, the DQN and
SAC train steps' loss, grad and apply, and the exported policy's act call
through its loader's span hook. Recording changes no number the program
computes."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from agents_tpu_torch.policies.policy_saver import PolicySaver
from agents_tpu_torch.utils import profiling
from examples import dqn_pixels_torch, sac_pendulum_torch

torch.set_num_threads(1)

ITERATIONS = 3
LOOPS = {
    "dqn_pixels": (dqn_pixels_torch, dict(
        env="pixels", pixels_size=12, pixels_frames=2, pixels_actions=4,
        pixels_horizon=16, env_batch_size=4, replay_capacity=16,
        sample_batch_size=8, initial_collect_steps=16,
        conv_layer_params=((8, 3, 2), (8, 3, 1)), fc_layer_params=(32,),
        dtype="float32", learning_rate=1e-3, epsilon_greedy=0.1,
        target_update_period=2, device="cpu")),
    "sac_pendulum": (sac_pendulum_torch, dict(
        max_episode_steps=8, env_batch_size=4, replay_capacity=64,
        sample_batch_size=16, train_steps_per_iteration=2,
        initial_collect_steps=16, actor_fc_layers=(16, 16),
        critic_joint_fc_layers=(16, 16), device="cpu")),
}
AGENT_SPANS = ("loop.sample", "agent.loss", "agent.grad", "agent.apply")


def _loop(name):
  module, fields = LOOPS[name]
  loop = module.build_loop(module.Config(**fields))
  return loop, loop.init(seed=5, initial_collect_steps=8)


def _leaves(agent_state):
  """Every tensor of the agent state: parameters, then optimizer moments."""
  out = []
  for value in vars(agent_state).values():
    if isinstance(value, torch.nn.Module):
      out += [p.detach() for p in value.parameters()]
    elif isinstance(value, torch.Tensor):
      out.append(value.detach())
    elif isinstance(value, torch.optim.Optimizer):
      out += [t for s in value.state.values() for t in s.values()
              if isinstance(t, torch.Tensor)]
  return out


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_each_iteration_opens_its_spans_and_counts(name):
  loop, state = _loop(name)
  with profiling.record() as rec:
    state, _ = loop.run(state, ITERATIONS)
  collect = loop.collect_steps
  out = rec.summary()
  assert out["counters"] == {
      "agent.train_steps": ITERATIONS * loop.train_steps}
  per_request = {}
  for span in rec.spans:
    names = per_request.setdefault(span.request, {})
    names[span.name] = names.get(span.name, 0) + 1
  assert per_request == {i: {
      "loop.iteration": 1, "loop.collect": 1, "replay.insert": collect,
      **{s: loop.train_steps for s in AGENT_SPANS}}
      for i in range(ITERATIONS)}
  parents = {span.name: span.parent.name if span.parent else None
             for span in rec.spans}
  assert parents == {"loop.iteration": None, "loop.collect": "loop.iteration",
                     "replay.insert": "loop.collect",
                     **{s: "loop.iteration" for s in AGENT_SPANS}}
  # The iteration's children cover all but its self time.
  spans = out["spans"]
  children = sum(spans[s]["total_ns"] for s in ("loop.collect",) + AGENT_SPANS)
  assert spans["loop.iteration"]["self_ns"] == (
      spans["loop.iteration"]["total_ns"] - children)
  assert spans["loop.collect"]["self_ns"] == (
      spans["loop.collect"]["total_ns"] - spans["replay.insert"]["total_ns"])


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_recording_changes_no_loss_nor_parameter(name):
  loop_off, state_off = _loop(name)
  loop_on, state_on = _loop(name)
  state_off, losses_off = loop_off.run(state_off, ITERATIONS)
  with profiling.record():
    state_on, losses_on = loop_on.run(state_on, ITERATIONS)
  assert torch.equal(losses_off, losses_on)
  off, on = _leaves(state_off.agent_state), _leaves(state_on.agent_state)
  assert len(off) == len(on) > 0
  assert all(torch.equal(a, b) for a, b in zip(off, on))
  assert state_off.agent_state.train_step == state_on.agent_state.train_step


def _exported(tmp_path):
  loop, _ = _loop("dqn_pixels")
  export = str(tmp_path / "policy")
  PolicySaver(loop.agent.policy).save(export, loop.agent.q_network)
  spec = importlib.util.spec_from_file_location(
      f"spans_loader_{abs(hash(export))}", os.path.join(export, "loader.py"))
  loader = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(loader)
  return loader.ExportedPolicy(export, platform="cpu")


def test_the_loaders_span_hook_changes_no_action(tmp_path):
  policy = _exported(tmp_path)
  rng = np.random.default_rng(3)
  obs = [rng.integers(0, 256, (2, 12, 12, 2), dtype=np.uint8)
         for _ in range(4)]
  unhooked = [policy.action([o])[0][0] for o in obs]
  with profiling.record() as rec:
    policy.span_hook = profiling.annotate
    hooked = [policy.action([o])[0][0] for o in obs]
    policy.span_hook = None
    again = [policy.action([o])[0][0] for o in obs]
  for a, b, c in zip(unhooked, hooked, again):
    assert np.array_equal(a, b) and np.array_equal(a, c)
  spans = rec.summary()["spans"]
  assert {name: s["calls"] for name, s in spans.items()} == {
      "act.call": 4, "act.prep": 4, "act.upload": 4, "act.program": 4,
      "act.fetch": 4}
  for span in rec.spans:
    if span.name == "act.call":
      assert span.parent is None
    else:
      assert span.parent.name == "act.call"
  assert sorted({s.request for s in rec.spans}) == [0, 1, 2, 3]
