"""Port parity: returns and GAE advantages (`agents_tpu_torch.utils.
value_ops`) against the JAX package's associative scans.

The inputs are numpy-made rewards, values and discounts with episode
boundaries (discount 0 on about one step in ten). The port runs a
reversed loop over T, the JAX package a parallel prefix scan, so the two
sum in different orders: float32 rtol 1e-5 / atol 1e-6 up to T=8, atol
1e-5 at T=2049, where 2,049-step sums of unit-scale rewards reach tens
and their last bits differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.utils import value_ops as jvalue_ops
from agents_tpu_torch.utils import value_ops
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)

B = 5


def _inputs(t, seed=0):
  rng = np.random.RandomState(seed)
  rewards = rng.randn(t, B).astype(np.float32)
  values = rng.randn(t, B).astype(np.float32)
  final = rng.randn(B).astype(np.float32)
  discounts = (0.99 * (rng.rand(t, B) > 0.1)).astype(np.float32)
  return rewards, values, final, discounts


def _atol(t):
  return 1e-5 if t > 8 else 1e-6


@pytest.mark.parametrize("t", [1, 8, 2049])
@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("bootstrap", [True, False])
def test_discounted_return_matches_jax(t, time_major, bootstrap):
  rewards, _, final, discounts = _inputs(t)
  if not time_major:
    rewards, discounts = rewards.T.copy(), discounts.T.copy()
  fv = final if bootstrap else None
  expect = jvalue_ops.discounted_return(
      jnp.asarray(rewards), jnp.asarray(discounts),
      None if fv is None else jnp.asarray(fv), time_major=time_major)
  got = value_ops.discounted_return(
      torch.from_numpy(rewards), torch.from_numpy(discounts),
      None if fv is None else torch.from_numpy(fv), time_major=time_major)
  assert tuple(got.shape) == rewards.shape
  assert_close(got, expect, 1e-5, _atol(t))


@pytest.mark.parametrize("t", [1, 8, 2049])
def test_discounted_return_first_step_only(t):
  """`provide_all_returns=False` gives G_0, [B], in either layout."""
  rewards, _, final, discounts = _inputs(t, seed=1)
  expect = jvalue_ops.discounted_return(
      jnp.asarray(rewards), jnp.asarray(discounts), jnp.asarray(final),
      provide_all_returns=False)
  for time_major in (True, False):
    r, d = (rewards, discounts) if time_major else (rewards.T.copy(),
                                                    discounts.T.copy())
    got = value_ops.discounted_return(
        torch.from_numpy(r), torch.from_numpy(d), torch.from_numpy(final),
        time_major=time_major, provide_all_returns=False)
    assert tuple(got.shape) == (B,)
    assert_close(got, expect, 1e-5, _atol(t))


@pytest.mark.parametrize("t", [1, 8, 2049])
@pytest.mark.parametrize("time_major", [True, False])
def test_gae_matches_jax(t, time_major):
  rewards, values, final, discounts = _inputs(t, seed=2)
  if not time_major:
    rewards, values, discounts = (x.T.copy() for x in (rewards, values,
                                                       discounts))
  expect = jvalue_ops.generalized_advantage_estimation(
      jnp.asarray(values), jnp.asarray(final), jnp.asarray(discounts),
      jnp.asarray(rewards), td_lambda=0.95, time_major=time_major)
  got = value_ops.generalized_advantage_estimation(
      torch.from_numpy(values), torch.from_numpy(final),
      torch.from_numpy(discounts), torch.from_numpy(rewards), td_lambda=0.95,
      time_major=time_major)
  assert tuple(got.shape) == values.shape
  assert_close(got, expect, 1e-5, _atol(t))


def test_gae_with_lambda_one_is_return_minus_value():
  """A_t at lambda 1 telescopes to G_t - V_t (bootstrapped from V_T)."""
  rewards, values, final, discounts = (torch.from_numpy(x)
                                       for x in _inputs(8, seed=3))
  adv = value_ops.generalized_advantage_estimation(values, final, discounts,
                                                   rewards, td_lambda=1.0)
  ret = value_ops.discounted_return(rewards, discounts, final)
  assert_close(adv, ret - values, 1e-5, 1e-5)
