"""Port parity: Q policy, greedy and epsilon-greedy wrappers and the
Categorical (`agents_tpu_torch.policies`, `.distributions`) against the
JAX package.

The epsilon-greedy coin and random action are derived from the JAX
policy's own key split (wrappers.py:78,94,125) and replayed into the
port, so the two must pick the same action on every row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.policies import q_policy as jq_policy
from agents_tpu.policies import wrappers as jwrappers
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.distributions import Categorical
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.policies import (EpsilonGreedyPolicy, GreedyPolicy,
                                       QPolicy)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_equal

torch.set_num_threads(1)

B = 64


def _policies(epsilon):
  jobs, jact = (jspec.ArraySpec((4,), np.float32),
                jspec.BoundedArraySpec((), np.int32, 0, 1))
  jnet = jnetworks.make_q_network(jobs, jact, fc_layer_params=(16, 8))
  params = jnet.init_params(jax.random.key(0))
  jq = jq_policy.QPolicy(jts.time_step_spec(jobs), jact, jnet)

  tobs, tact = (tspec.ArraySpec((4,), np.float32),
                tspec.BoundedArraySpec((), np.int32, 0, 1))
  tnet = make_q_network(tobs, tact, fc_layer_params=(16, 8), device="cpu")
  tnet.load_state_dict(convert.q_params_to_state_dict(jax.device_get(params)))
  tq = QPolicy(tts.time_step_spec(tobs), tact, tnet)
  return ((jwrappers.GreedyPolicy(jq), jwrappers.EpsilonGreedyPolicy(
      jq, epsilon), params), (GreedyPolicy(tq), EpsilonGreedyPolicy(
          tq, epsilon), tnet), jact)


def _time_steps():
  obs = np.random.RandomState(0).randn(B, 4).astype(np.float32) * 2.0
  return (jts.restart(jnp.asarray(obs), batch_size=B),
          tts.restart(torch.from_numpy(obs), batch_size=B))


def test_greedy_policy_matches_jax():
  (jgreedy, _, params), (tgreedy, _, tnet), _ = _policies(0.1)
  jstep, tstep = _time_steps()
  ja = jgreedy.action(params, jstep, (), jax.random.key(0)).action
  ta = tgreedy.action(tnet, tstep).action
  assert ta.dtype == torch.int32
  assert_equal(ta, ja)
  # Both actions occur, so the comparison is not trivial.
  assert set(np.asarray(ja).tolist()) == {0, 1}


def test_epsilon_greedy_matches_jax_with_injected_draws():
  (_, jeps, params), (_, teps, tnet), jact = _policies(0.5)
  jstep, tstep = _time_steps()
  explored = 0
  for seed in range(3):
    key = jax.random.key(seed)
    ja = jeps.action(params, jstep, (), key).action
    _, k_rand, k_mix = jax.random.split(key, 3)
    random_action = jspec.sample_spec_nest(jact, k_rand, outer_dims=(B,))
    coin = jax.random.uniform(k_mix, (B,))
    draws = ReplayDraws({"random_action": [np.asarray(random_action)],
                         "explore": [np.asarray(coin)]})
    ta = teps.action(tnet, tstep, (), draws).action
    assert_equal(ta, ja, f"seed {seed}")
    assert ta.dtype == torch.int32
    assert draws.remaining() == {"random_action": 0, "explore": 0}
    greedy = np.asarray(jwrappers.GreedyPolicy(jeps.wrapped).action(
        params, jstep).action)
    explored += int((np.asarray(coin) < 0.5).sum())
    # Rows whose coin came up over epsilon act greedily.
    keep = np.asarray(coin) >= 0.5
    assert_equal(ta.numpy()[keep], greedy[keep])
  assert 0 < explored < 3 * B


def test_epsilon_schedule_reads_params():
  """A callable epsilon sees the policy params at act time."""
  (_, _, _), (_, teps, tnet), _ = _policies(lambda p: 1.0)
  _, tstep = _time_steps()
  draws = ReplayDraws({"random_action": [np.ones(B, np.int32)],
                       "explore": [np.full(B, 0.99, np.float32)]})
  ta = teps.action(tnet, tstep, (), draws).action
  assert_equal(ta, np.ones(B, np.int32))


def test_categorical_mode_first_index_on_ties_and_sample_frequencies():
  logits = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0]])
  d = Categorical(logits=logits)
  assert_equal(d.mode(), np.array([0, 1], np.int32))
  assert_equal(d.mode(), jnp.argmax(jnp.asarray(logits.numpy()), -1))
  probs = torch.tensor([0.2, 0.5, 0.3])
  d = Categorical(logits=torch.log(probs))
  s = d.sample(Draws(0, "cpu"), sample_shape=(20000,))
  freq = torch.bincount(s.long(), minlength=3).float() / 20000
  assert torch.allclose(freq, probs, atol=0.02)
