"""`agents_tpu_torch.utils.composite` against the JAX package's module
(``tests/test_composite.py``'s cases): every sparse and ragged op on the
same inputs gives the same indices, masks, lengths and dense values as
the JAX op, exactly (they move values, they do not compute with them).
Indices are int64 in the port, int32 in JAX; they compare by value."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.utils import composite as jcomp
from agents_tpu_torch.utils import composite as comp


def _dense():
  x = np.zeros((3, 4), np.float32)
  x[0, 1] = 2.0
  x[1, 0] = -1.0
  x[2, 3] = 5.0
  return x


def _pair(capacity):
  x = _dense()
  return (comp.SparseArray.from_dense(torch.as_tensor(x), capacity),
          jcomp.SparseArray.from_dense(jnp.asarray(x), capacity))


def _assert_same_sparse(t, j):
  assert t.dense_shape == j.dense_shape
  np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
  np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
  np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
  np.testing.assert_array_equal(t.to_dense().numpy(),
                                np.asarray(j.to_dense()))


@pytest.mark.parametrize("capacity", [3, 5, 12, 20])
def test_from_dense_matches_jax(capacity):
  t, j = _pair(capacity)
  _assert_same_sparse(t, j)
  assert int(t.nnz()) == int(j.nnz()) == 3
  np.testing.assert_array_equal(t.to_dense().numpy(), _dense())


def test_capacity_check():
  with pytest.raises(ValueError):
    comp.SparseArray.from_dense(torch.ones(3, 3), capacity=4)


def test_shape_dispatch():
  t, j = _pair(4)
  x = _dense()
  np.testing.assert_array_equal(comp.shape(t).numpy(),
                                np.asarray(jcomp.shape(j)))
  np.testing.assert_array_equal(comp.shape(torch.as_tensor(x)).numpy(),
                                np.asarray(jcomp.shape(jnp.asarray(x))))
  r = comp.RaggedArray.from_rows([np.zeros(2, np.float32)], device="cpu")
  assert comp.shape(r).tolist() == [1, 2]


@pytest.mark.parametrize("new_shape", [(4, 3), (12,), (2, -1), (1, 3, 4)])
def test_reshape_matches_jax(new_shape):
  t, j = _pair(4)
  _assert_same_sparse(comp.reshape(t, new_shape), jcomp.reshape(j, new_shape))
  dense = comp.reshape(torch.as_tensor(_dense()), new_shape)
  np.testing.assert_array_equal(
      dense.numpy(), np.asarray(jcomp.reshape(jnp.asarray(_dense()),
                                              new_shape)))


def test_squeeze_expand_match_jax():
  t, j = _pair(4)
  te, je = comp.expand_dims(t, 1), jcomp.expand_dims(j, 1)
  _assert_same_sparse(te, je)
  _assert_same_sparse(comp.squeeze(te, 1), jcomp.squeeze(je, 1))
  np.testing.assert_array_equal(
      comp.expand_dims(torch.as_tensor(_dense()), 1).numpy(),
      np.asarray(jcomp.expand_dims(jnp.asarray(_dense()), 1)))
  with pytest.raises(ValueError):
    comp.squeeze(t, 0)


@pytest.mark.parametrize("axis,start", [(0, 1), (1, 2), (0, -2)])
def test_slice_from_matches_jax(axis, start):
  t, j = _pair(4)
  _assert_same_sparse(comp.slice_from(t, axis, start),
                      jcomp.slice_from(j, axis, start))
  np.testing.assert_array_equal(
      comp.slice_from(torch.as_tensor(_dense()), axis, start).numpy(),
      np.asarray(jcomp.slice_from(jnp.asarray(_dense()), axis, start)))


@pytest.mark.parametrize("axis,end", [(0, 2), (1, 3), (1, -1)])
def test_slice_to_matches_jax(axis, end):
  t, j = _pair(4)
  _assert_same_sparse(comp.slice_to(t, axis, end),
                      jcomp.slice_to(j, axis, end))
  np.testing.assert_array_equal(
      comp.slice_to(torch.as_tensor(_dense()), axis, end).numpy(),
      np.asarray(jcomp.slice_to(jnp.asarray(_dense()), axis, end)))


def _rows():
  return [np.arange(3, dtype=np.float32), np.arange(1, dtype=np.float32),
          np.arange(4, dtype=np.float32)]


def test_ragged_from_rows_mask_splits_match_jax():
  t = comp.RaggedArray.from_rows(_rows(), device="cpu")
  j = jcomp.RaggedArray.from_rows(_rows())
  np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
  np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
  np.testing.assert_array_equal(t.row_splits().numpy(),
                                np.asarray(j.row_splits()))
  np.testing.assert_array_equal(t.mask().numpy(), np.asarray(j.mask()))
  assert t.row_splits().tolist() == [0, 3, 4, 8]


@pytest.mark.parametrize("op,arg", [("slice_to", 2), ("slice_from", 2),
                                    ("slice_to", 3), ("slice_from", 0)])
def test_ragged_slicing_matches_jax(op, arg):
  t = getattr(comp, op)(comp.RaggedArray.from_rows(_rows(), device="cpu"),
                        1, arg)
  j = getattr(jcomp, op)(jcomp.RaggedArray.from_rows(_rows()), 1, arg)
  np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
  np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
  with pytest.raises(ValueError):
    getattr(comp, op)(comp.RaggedArray.from_rows(_rows(), device="cpu"), 0,
                      arg)
