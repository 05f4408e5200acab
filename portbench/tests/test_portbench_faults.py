"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have: a step that returns its state unchanged,
half of the batch left out (the mean over the rest), an answer altered
where it is produced; and, for the DQN, a target update skipped, and
for both training cells a replay sample that hands the train step other
windows than the ring holds. The exchange between chips is no fault of
these one-chip cells. The harness's look for a card is skipped (CPU, tiny
sizes)."""
import dataclasses

import pytest
import torch
from torch import nn

from agents_tpu_torch.utils import nest_utils
from portbench import harness
from portbench.tests._tiny import SEED, TINY


def _tensors(agent_state):
  out = []
  for field in dataclasses.fields(agent_state):
    value = getattr(agent_state, field.name)
    if isinstance(value, nn.Module):
      out += list(value.parameters())
    elif isinstance(value, torch.Tensor):
      out.append(value)
  return out


def unchanged(loop):
  """Every train step leaves the parameters as they were."""
  original = loop.agent.train

  def train(agent_state, experience, weights=None):
    kept = [t.detach().clone() for t in _tensors(agent_state)]
    new_state, info = original(agent_state, experience, weights=weights)
    with torch.no_grad():
      for t, k in zip(_tensors(new_state), kept):
        t.copy_(k)
    return new_state, info

  loop.agent.train = train


def half_batch(loop):
  """Every train step sees the first half of its sample."""
  original = loop.agent.train

  def train(agent_state, experience, weights=None):
    half = nest_utils.tree_map(lambda x: x[:x.shape[0] // 2], experience)
    return original(agent_state, half, weights=weights)

  loop.agent.train = train


def altered(loop):
  """Row 0's collected action is another one."""
  policy = loop.driver.policy
  original = policy.action
  spec = loop.env.action_spec()

  def action(*args, **kwargs):
    step = original(*args, **kwargs)
    a = step.action.clone()
    if a.is_floating_point():
      a[0] = torch.where(a[0] > 0, a[0] - 0.5, a[0] + 0.5)
    else:
      a[0] = (a[0] + 1) % (int(spec.maximum) + 1)
    return step.replace(action=a)

  policy.action = action


def skipped_target_update(loop):
  """Every train step leaves the target network as it was."""
  original = loop.agent.train

  def train(agent_state, experience, weights=None):
    target = agent_state.target_q_network
    kept = [p.detach().clone() for p in target.parameters()]
    new_state, info = original(agent_state, experience, weights=weights)
    with torch.no_grad():
      for p, k in zip(new_state.target_q_network.parameters(), kept):
        p.copy_(k)
    return new_state, info

  loop.agent.train = train


def shifted_sample(loop):
  """Every sampled window's frames are the next window's."""
  original = loop.replay.sample

  def sample(*args, **kwargs):
    experience, info = original(*args, **kwargs)
    obs = torch.roll(experience.observation, 1, dims=0)
    return experience.replace(observation=obs), info

  loop.replay.sample = sample


class _AlteredExport:
  """An exported policy whose every action is the next one."""

  def __init__(self, exported, num_actions=6):
    self._exported, self._n = exported, num_actions

  def __getattr__(self, name):
    return getattr(self._exported, name)

  def action(self, *args, **kwargs):
    actions, state = self._exported.action(*args, **kwargs)
    return [(a + 1) % self._n for a in actions], state


TRAINING = ["dqn_mnih15.fused_b128", "sac_haarnoja18.fused_utd1"]


@pytest.mark.parametrize("cell", TRAINING)
@pytest.mark.parametrize("plant", [unchanged, half_batch, altered],
                         ids=lambda p: p.__name__)
def test_a_broken_training_step_is_not_correct(cell, plant):
  line = harness.run_cell(cell, SEED, 0.3, False, device="cpu", plant=plant,
                          fields=TINY[cell])
  assert line["correct"] is False, line["checks"]


def test_a_skipped_target_update_is_not_correct():
  cell = "dqn_mnih15.fused_b128"
  line = harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                          plant=skipped_target_update, fields=TINY[cell])
  assert line["correct"] is False
  assert line["checks"]["target_mismatch"]["value"] > 0, line["checks"]


@pytest.mark.parametrize("cell", TRAINING)
def test_a_shifted_sample_is_not_correct(cell):
  line = harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                          plant=shifted_sample, fields=TINY[cell])
  assert line["correct"] is False
  assert line["checks"]["sample_mismatch"]["value"] > 0, line["checks"]


def test_an_altered_action_is_not_correct():
  line = harness.run_cell("dqn_mnih15.act_b1", SEED, 0.5, False,
                          device="cpu", plant=_AlteredExport)
  assert line["correct"] is False, line["checks"]
