"""Port parity: the streaming and EMA normalizers (`agents_tpu_torch.utils.
tensor_normalizer`) against the JAX package's, over six numpy-made batches;
normalize with clipping and without centering; and the ports of
`test_on_policy_agents.py`'s two normalizer tests. Float32 rtol 1e-5 /
atol 1e-6 unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import specs as jspecs
from agents_tpu.utils import tensor_normalizer as jtn
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.utils import tensor_normalizer as ttn
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)


def _batches(shape, seed=0):
  rng = np.random.RandomState(seed)
  # Offset and scaled per feature, so centering and scaling both matter.
  return [(3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
          for _ in range(6)]


def _pair(kind, shape, **kwargs):
  jcls, tcls = {"streaming": (jtn.StreamingTensorNormalizer,
                              ttn.StreamingTensorNormalizer),
                "ema": (jtn.EMATensorNormalizer,
                        ttn.EMATensorNormalizer)}[kind]
  return (jcls(jspecs.ArraySpec(shape, np.float32), **kwargs),
          tcls(tspec.ArraySpec(shape, np.float32), **kwargs))


def _fields(state):
  return {k: np.asarray(v) for k, v in vars(state).items()}


@pytest.mark.parametrize("kind,kwargs", [("streaming", {}),
                                         ("ema", {"norm_update_rate": 0.1})])
@pytest.mark.parametrize("shape,outer", [((4,), (32,)), ((), (8, 16)),
                                         ((3,), (2, 5))])
def test_normalizer_updates_and_normalize_match_jax(kind, kwargs, shape,
                                                    outer):
  jnorm, tnorm = _pair(kind, shape, **kwargs)
  jstate, tstate = jnorm.init(), tnorm.init("cpu")
  for batch in _batches(outer + shape):
    jstate = jnorm.update(jstate, jnp.asarray(batch))
    tstate = tnorm.update(tstate, torch.from_numpy(batch))
    jf = jax.device_get(vars(jstate))
    for name, value in vars(tstate).items():
      assert_close(value, jf[name], 1e-5, 1e-6, name)
  x = _batches(outer + shape, seed=1)[0] * 3.0
  for clip, center in ((5.0, True), (1.0, True), (10.0, False), (0.0, True)):
    assert_close(tnorm.normalize(tstate, torch.from_numpy(x), clip, center),
                 jnorm.normalize(jstate, jnp.asarray(x), clip, center),
                 1e-5, 1e-6, f"clip {clip} center {center}")


def test_normalizer_over_a_nest():
  spec = {"a": (2,), "b": ()}
  jspec = {k: jspecs.ArraySpec(v, np.float32) for k, v in spec.items()}
  tsp = {k: tspec.ArraySpec(v, np.float32) for k, v in spec.items()}
  jnorm, tnorm = (jtn.StreamingTensorNormalizer(jspec),
                  ttn.StreamingTensorNormalizer(tsp))
  rng = np.random.RandomState(4)
  values = {"a": rng.randn(6, 2).astype(np.float32),
            "b": rng.randn(6).astype(np.float32)}
  jstate = jnorm.update(jnorm.init(), jax.tree_util.tree_map(jnp.asarray,
                                                             values))
  tstate = tnorm.update(tnorm.init("cpu"),
                        {k: torch.from_numpy(v) for k, v in values.items()})
  got = tnorm.normalize(tstate, {k: torch.from_numpy(v)
                                 for k, v in values.items()})
  expect = jnorm.normalize(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                          values))
  assert set(got) == {"a", "b"}
  for k in got:
    assert_close(got[k], expect[k], 1e-5, 1e-6, k)


def test_streaming_normalizer_exact_parallel_variance():
  """Port of `test_on_policy_agents.py`'s test: the streaming statistics
  match the whole data set's exact mean and variance (Chan's combine)."""
  norm = ttn.StreamingTensorNormalizer(tspec.ArraySpec((), np.float32))
  state = norm.init("cpu")
  rng = np.random.RandomState(0)
  data = (10.0 + rng.randn(6, 32)).astype(np.float32)  # mean 10, std 1
  for batch in data:
    state = norm.update(state, torch.from_numpy(batch))
  count = float(state.count)
  np.testing.assert_allclose(float(state.mean_sum) / count, data.mean(),
                             rtol=1e-5)
  np.testing.assert_allclose(float(state.var_sum) / count, data.var(),
                             rtol=1e-4)


def test_ema_normalizer_survives_batch_size_one():
  """Port of `test_on_policy_agents.py`'s test: the EMA variance is taken
  about the moving mean, so a stream of single samples keeps it up."""
  norm = ttn.EMATensorNormalizer(tspec.ArraySpec((), np.float32),
                                 norm_update_rate=0.05)
  state = norm.init("cpu")
  rng = np.random.RandomState(1)
  for _ in range(400):  # a stream of single samples ~ N(3, 2^2)
    state = norm.update(state, torch.tensor(
        [np.float32(3.0 + 2.0 * rng.randn())]))
  assert float(state.var) > 1.0
