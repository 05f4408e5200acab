"""Port parity: `MaskedCategorical`, `ShiftedCategorical`,
`OneHotCategorical`, `GumbelSoftmax`, `Bernoulli` and `Beta`
(`agents_tpu_torch.distributions`) against the JAX package's.

Each is built from the same parameters on both sides; log-probabilities,
entropies, modes and means agree to rtol 1e-5 / atol 1e-6 (Beta's
`lgamma`/`digamma` terms to rtol 1e-5 / atol 1e-5) and samples replay the
JAX side's draws: a categorical sample's uniforms in [tiny, 1) (the Gumbel
noise of ``jax.random.categorical`` and ``jax.random.gumbel``), a
Bernoulli's uniforms in [0, 1). Beta's sampler differs by design: the JAX
package draws two log-gamma variates inside ``jax.random.beta``, the port
two standard-gamma variates at "beta_gamma". So the test replays JAX's
beta sample b as the pair (b, 1 - b), which the port's ``x / (x + y)``
returns to within an ulp, and holds the port's own gamma draws to their
moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import distributions as jdist
from agents_tpu.distributions import distributions as jdist_module
from agents_tpu_torch import distributions as tdist
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

B, K = 16, 5


def _logits(seed=0, shape=(B, K)):
  return (np.random.RandomState(seed).randn(*shape) * 2).astype(np.float32)


def _t(x):
  return torch.from_numpy(np.array(x))


def _gumbel_uniforms(key, shape):
  return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                       minval=jnp.finfo(jnp.float32).tiny,
                                       maxval=1.0))


def test_neg_inf_is_the_jax_value():
  assert tdist.NEG_INF == jdist_module.NEG_INF == -1e9


def _mask(seed=1):
  rng = np.random.RandomState(seed)
  mask = rng.rand(B, K) < 0.5
  mask[np.arange(B), rng.randint(0, K, B)] = True
  mask[0] = [True, False, False, False, False]       # one valid action
  return mask


CATEGORICALS = {
    "masked": (lambda lg: jdist.MaskedCategorical(jnp.asarray(lg),
                                                  jnp.asarray(_mask())),
               lambda lg: tdist.MaskedCategorical(_t(lg), _t(_mask()))),
    "shifted": (lambda lg: jdist.ShiftedCategorical(jnp.asarray(lg), shift=3),
                lambda lg: tdist.ShiftedCategorical(_t(lg), shift=3)),
    "one_hot": (lambda lg: jdist.OneHotCategorical(jnp.asarray(lg)),
                lambda lg: tdist.OneHotCategorical(_t(lg)))}


@pytest.mark.parametrize("name", list(CATEGORICALS))
def test_categorical_variants_match_jax(name):
  jmake, tmake = CATEGORICALS[name]
  logits = _logits()
  jd, td = jmake(logits), tmake(logits)
  key = jax.random.key(2)
  jsample = jd.sample(key, (3,))
  tsample = td.sample(ReplayDraws({"categorical": [
      _gumbel_uniforms(key, (3, B, K))]}), (3,))
  assert_equal(tsample, jsample)
  assert str(tsample.dtype).split(".")[-1] == str(jsample.dtype)
  assert_equal(td.mode(), jd.mode())
  assert_close(td.log_prob(tsample[0]), jd.log_prob(jsample[0]))
  assert_close(td.entropy(), jd.entropy())
  if name == "masked":
    assert bool(_mask()[np.arange(B), tsample.numpy()].all())
    assert float(td.log_prob(torch.zeros(B, dtype=torch.int32))[0]) == 0.0
  if name == "shifted":
    assert int(tsample.min()) >= 3 and int(tsample.max()) < 3 + K
  if name == "one_hot":
    assert tuple(tsample.shape) == (3, B, K)
    assert bool((tsample.sum(-1) == 1).all())


def test_gumbel_softmax_matches_jax_with_a_straight_through_gradient():
  logits = _logits(3)
  jd = jdist.GumbelSoftmax(jnp.asarray(logits), temperature=0.7)
  td = tdist.GumbelSoftmax(_t(logits), temperature=0.7)
  key = jax.random.key(4)
  jsample = jd.sample(key)
  tsample = td.sample(ReplayDraws({"gumbel_softmax": [
      _gumbel_uniforms(key, (B, K))]}))
  assert_close(tsample, jsample)
  assert_close(td.log_prob(tsample), jd.log_prob(jsample))
  assert_close(td.entropy(), jd.entropy())
  assert_equal(td.mode(), jd.mode())
  w = np.random.RandomState(5).randn(B, K).astype(np.float32)
  jhard, jgrad = jax.value_and_grad(
      lambda s: jnp.sum(jd.convert_to_one_hot(s) * w))(jsample)
  soft = tsample.clone().requires_grad_(True)
  hard = td.convert_to_one_hot(soft)
  (hard * _t(w)).sum().backward()
  assert_close(hard.detach(), jd.convert_to_one_hot(jsample))
  assert_close(soft.grad, jgrad)
  assert_close((hard.detach() * _t(w)).sum(), jhard)
  assert bool((hard.detach().sum(-1) == 1).all())


def test_bernoulli_matches_jax():
  logits = _logits(6, (B,))
  jd, td = jdist.Bernoulli(jnp.asarray(logits)), tdist.Bernoulli(_t(logits))
  key = jax.random.key(7)
  jsample = jd.sample(key, (4,))
  tsample = td.sample(ReplayDraws({"bernoulli": [np.asarray(
      jax.random.uniform(key, (4, B)))]}), (4,))
  assert_equal(tsample, jsample)
  assert tsample.dtype == torch.int32
  assert_close(td.log_prob(tsample), jd.log_prob(jsample))
  assert_close(td.entropy(), jd.entropy())
  assert_equal(td.mode(), jd.mode())
  assert_close(td.mean(), jd.mean())
  assert_close(td.probs, jd.probs)


BETA_RTOL = BETA_ATOL = 1e-5


def test_beta_matches_jax():
  rng = np.random.RandomState(8)
  a = rng.uniform(1.5, 6.0, (B,)).astype(np.float32)
  b = np.float32(2.5)
  jd = jdist.Beta(jnp.asarray(a), jnp.asarray(b))
  td = tdist.Beta(_t(a), _t(b))
  key = jax.random.key(9)
  jsample = np.asarray(jd.sample(key, (3,)))
  tsample = td.sample(ReplayDraws({"beta_gamma": [jsample, 1.0 - jsample]}),
                      (3,))
  assert tuple(tsample.shape) == (3, B)
  assert_close(tsample, jsample, 1e-6, 1e-7)
  for name in ("mean", "mode", "entropy"):
    assert_close(getattr(td, name)(), getattr(jd, name)(), BETA_RTOL,
                 BETA_ATOL, name)
  assert_close(td.log_prob(tsample), jd.log_prob(jnp.asarray(jsample)),
               BETA_RTOL, BETA_ATOL)


def test_beta_and_gamma_draws_have_their_moments():
  """The generator-backed sampler: standard-gamma means and variances equal
  the shape (below 1 too), and Beta's mean a / (a + b),
  within four standard errors over 20,000 draws."""
  draws = Draws(0, "cpu")
  shape = torch.tensor([0.3, 1.0, 2.5, 9.0])
  g = draws.gamma("beta_gamma", shape.expand(20000, 4))
  assert bool((g > 0).all())
  se = torch.sqrt(shape / 20000)
  assert bool(((g.mean(0) - shape).abs() < 4 * se).all())
  assert bool(((g.var(0) - shape).abs() < 0.1 * shape + 0.02).all())
  d = tdist.Beta(torch.tensor([2.0, 0.5]), torch.tensor([3.0, 0.5]))
  x = d.sample(draws, (20000,))
  assert bool(((x >= 0) & (x <= 1)).all())
  assert_close(x.mean(0), d.mean(), atol=0.01)
