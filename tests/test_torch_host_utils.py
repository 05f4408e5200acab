"""The host helpers of the PyTorch port against the JAX package's:
`nest_utils` (sorted-key map, flatten and unflatten; stack, unstack,
batch, unbatch, tile, select, prune, outer shape), `array_spec`
(`np_sample_spec_nest` bit for bit from one `RandomState`,
`check_arrays_nest`, the outer-dims helpers, `spec_from_array_nest`),
`time_step` (`transition`, `termination`, `truncation`), `trajectory`
(`first`, `mid`, `last`, `boundary`, `single_step`, `from_episode`,
`to_transition_spec`) and `common` (`discounted_future_sum`,
`compute_returns`, `OUProcess`). Values are compared exactly, float
arithmetic at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import specs as jspecs
from agents_tpu.specs import array_spec as jarray_spec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu.utils import nest_utils as jnest
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal
from test_torch_py_environments import to_jax_spec

NEST = {"z": np.arange(6.).reshape(3, 2), "a": (np.arange(3), np.ones(3)),
        "m": {"y": np.zeros((3, 1)), "b": np.full(3, 7)}}


def test_sorted_flatten_is_jax_leaf_order():
  assert [id(x) for x in nest_utils.flatten_sorted(NEST)] == [
      id(x) for x in jax.tree_util.tree_leaves(NEST)]
  leaves = list(range(5))
  tree = nest_utils.unflatten_sorted(NEST, leaves)
  jtree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(NEST),
                                       leaves)
  assert tree == jtree
  assert list(tree) == ["z", "a", "m"]       # each dict keeps its own order
  calls = []
  nest_utils.tree_map_sorted(lambda x: calls.append(id(x)), NEST)
  assert calls == [id(x) for x in jax.tree_util.tree_leaves(NEST)]


def _same(tnest, jnest_value):
  for a, b in zip(nest_utils.flatten_sorted(tnest),
                  jax.tree_util.tree_leaves(jnest_value), strict=True):
    assert_equal(a, b)


def test_numpy_nest_helpers_match_jax():
  nests = [jax.tree_util.tree_map(lambda x, i=i: x + i, NEST)
           for i in range(4)]
  stacked = nest_utils.stack_nested_arrays(nests, axis=1)
  _same(stacked, jnest.stack_nested_arrays(nests, axis=1))
  for t, j in zip(nest_utils.unstack_nested_arrays(NEST),
                  jnest.unstack_nested_arrays(NEST), strict=True):
    _same(t, j)
  _same(nest_utils.batch_nested_array(NEST), jnest.batch_nested_array(NEST))
  _same(nest_utils.unbatch_nested_array(nest_utils.batch_nested_array(NEST)),
        NEST)
  _same(nest_utils.tile_batch(NEST, 3), jnest.tile_batch(NEST, 3))
  _same(nest_utils.select_batch(NEST, np.array([2, 0])),
        jnest.select_batch(NEST, np.array([2, 0])))
  torch_nest = nest_utils.tree_map(torch.as_tensor, NEST)
  _same(nest_utils.tile_batch(torch_nest, 2), jnest.tile_batch(NEST, 2))
  _same(nest_utils.batch_nested_array(torch_nest),
        jnest.batch_nested_array(NEST))


def test_prune_extra_keys_matches_jax():
  narrow = {"a": 1, "c": {"x": 1}, "t": (1, 2)}
  wide = {"a": 5, "b": 6, "c": {"x": 7, "y": 8}, "t": ({"k": 1}, 2)}
  assert nest_utils.prune_extra_keys(narrow, wide) == jnest.prune_extra_keys(
      narrow, wide) == {"a": 5, "c": {"x": 7}, "t": ({"k": 1}, 2)}


def test_get_outer_shape_matches_jax():
  specs = {"o": tspec.ArraySpec((2,), np.float32),
           "s": tspec.ArraySpec((), np.int32)}
  nest = {"o": np.zeros((4, 5, 2)), "s": np.zeros((4, 5))}
  assert nest_utils.get_outer_shape(nest, specs) == jnest.get_outer_shape(
      nest, to_jax_spec(specs)) == (4, 5)
  assert nest_utils.get_outer_rank(nest, specs) == 2
  with pytest.raises(ValueError):
    nest_utils.get_outer_shape({"o": np.zeros((4, 5, 2)),
                                "s": np.zeros((4, 6))}, specs)
  with pytest.raises(ValueError):
    nest_utils.get_outer_rank({"o": np.zeros((4, 3)), "s": np.zeros(4)},
                              specs)


SAMPLE_SPECS = {
    "cont": tspec.BoundedArraySpec((2, 3), np.float32, -2.0, [1., 2., 3.]),
    "int": tspec.BoundedArraySpec((4,), np.int32, [0, 1, 2, 3], 5),
    "bool": tspec.BoundedArraySpec((3,), np.bool_),
    "free": tspec.ArraySpec((2,), np.float32),
    "freei": tspec.ArraySpec((), np.int64),
    "unbounded": tspec.BoundedArraySpec((2,), np.float64),
}


@pytest.mark.parametrize("outer", [(), (5,), (2, 3)])
def test_np_sample_spec_nest_equals_jax_bit_for_bit(outer):
  jspec_nest = to_jax_spec(SAMPLE_SPECS)
  t = tspec.np_sample_spec_nest(SAMPLE_SPECS, np.random.RandomState(9), outer)
  j = jarray_spec.np_sample_spec_nest(jspec_nest, np.random.RandomState(9),
                                      outer)
  _same(t, j)
  assert tspec.check_arrays_nest(
      t, tspec.add_outer_dims_nest(SAMPLE_SPECS, outer))


def test_check_arrays_nest_matches_jax():
  spec = {"x": tspec.BoundedArraySpec((2,), np.float32, 0, 1),
          "y": tspec.ArraySpec((), np.int32)}
  jspec = to_jax_spec(spec)
  cases = [
      {"x": np.zeros(2, np.float32), "y": np.zeros((), np.int32)},
      {"x": np.full(2, 2, np.float32), "y": np.zeros((), np.int32)},
      {"x": np.zeros(2, np.float64), "y": np.zeros((), np.int32)},
      {"x": np.zeros(2, np.float32)},
      {"x": np.zeros(2, np.float32), "w": np.zeros((), np.int32)},
      [np.zeros(2, np.float32), np.zeros((), np.int32)],
  ]
  for arrays in cases:
    assert tspec.check_arrays_nest(arrays, spec) == \
        jarray_spec.check_arrays_nest(arrays, jspec), arrays
  assert tspec.check_arrays_nest(
      {"x": torch.zeros(2), "y": torch.zeros((), dtype=torch.int32)}, spec)


def test_outer_dims_and_spec_from_arrays_match_jax():
  spec = {"x": tspec.BoundedArraySpec((2,), np.float32, 0, 1)}
  added = tspec.add_outer_dims_nest(spec, (4, 5))
  jadded = jarray_spec.add_outer_dims_nest(to_jax_spec(spec), (4, 5))
  assert repr(added["x"]) == repr(jadded["x"])
  assert tspec.remove_outer_dims_nest(added, 2)["x"] == spec["x"]
  with pytest.raises(ValueError):
    tspec.remove_outer_dims_nest(spec, 2)
  arrays = {"a": np.zeros((3, 2), np.int8), "b": torch.zeros(3, 4, 5)}
  inferred = tspec.spec_from_array_nest(arrays, 1)
  jinferred = jarray_spec.spec_from_array_nest(
      {"a": arrays["a"], "b": np.zeros((3, 4, 5), np.float32)}, 1)
  for k in arrays:
    assert inferred[k].shape == jinferred[k].shape
    assert inferred[k].dtype == jinferred[k].dtype


@pytest.mark.parametrize("fn,args", [
    ("transition", (0.9,)), ("termination", ()), ("truncation", (0.5,))])
def test_time_step_factories_match_jax(fn, args):
  obs = np.arange(6, dtype=np.float32).reshape(3, 2)
  reward = np.array([1., 2., 3.], np.float32)
  t = getattr(tts, fn)(torch.as_tensor(obs), torch.as_tensor(reward), *args)
  j = getattr(jts, fn)(jnp.asarray(obs), jnp.asarray(reward), *args)
  for f in ("step_type", "reward", "discount", "observation"):
    assert_equal(getattr(t, f), getattr(j, f))
    assert str(getattr(t, f).dtype).split(".")[-1] == str(
        getattr(j, f).dtype)
  t2 = getattr(tts, fn)(torch.zeros(2, 3, 1), torch.zeros(2, 3), *args,
                        outer_dims=(2, 3))
  assert tuple(t2.discount.shape) == (2, 3)


@pytest.mark.parametrize("fn", ["first", "mid", "last", "boundary",
                                "single_step"])
def test_trajectory_factories_match_jax(fn):
  args = (np.ones((3, 2), np.float32), np.zeros(3, np.int32), (),
          np.full(3, 0.5, np.float32), np.full(3, 0.9, np.float32))
  t = getattr(ttj, fn)(*args)
  j = getattr(jtj, fn)(*args)
  for f in ("step_type", "observation", "action", "next_step_type",
            "reward", "discount"):
    assert_equal(getattr(t, f), getattr(j, f))


def test_from_episode_and_transition_spec_match_jax():
  obs, act = np.arange(8.).reshape(4, 2), np.arange(4)
  rew = np.array([1., 2., 3., 4.], np.float32)
  for disc in (None, np.array([1., 1., .5, 0.], np.float32)):
    t = ttj.from_episode(obs, act, (), rew, disc)
    j = jtj.from_episode(obs, act, (), rew, disc)
    for f in ("step_type", "next_step_type", "discount", "reward"):
      assert_equal(getattr(t, f), getattr(j, f))
  spec = ttj.trajectory_spec(tts.time_step_spec(tspec.ArraySpec(
      (2,), np.float32)), tspec.BoundedArraySpec((), np.int32, 0, 1))
  tr = ttj.to_transition_spec(spec)
  assert tr.time_step.observation == spec.observation
  assert tr.next_time_step.reward == spec.reward
  assert tr.action_step.action == spec.action


def test_discounted_future_sum_and_returns_match_jax():
  rng = np.random.RandomState(0)
  values = rng.randn(3, 7).astype(np.float32)
  assert_close(common.discounted_future_sum(torch.as_tensor(values), 0.9, 3),
               jcommon.discounted_future_sum(jnp.asarray(values), 0.9, 3),
               1e-6, 1e-6)
  disc = (rng.rand(3, 7) > 0.2).astype(np.float32) * 0.99
  assert_close(common.compute_returns(torch.as_tensor(values),
                                      torch.as_tensor(disc)),
               jcommon.compute_returns(jnp.asarray(values),
                                       jnp.asarray(disc)), 1e-6, 1e-6)
  assert_close(common.compute_returns(torch.as_tensor(values.T),
                                      torch.as_tensor(disc.T),
                                      time_major=True),
               jcommon.compute_returns(jnp.asarray(values.T),
                                       jnp.asarray(disc.T), time_major=True),
               1e-6, 1e-6)


def test_ou_process_matches_jax():
  jou = jcommon.OUProcess((2,), damping=0.15, stddev=0.2)
  tou = common.OUProcess((2,), damping=0.15, stddev=0.2)
  jstate, key, normals = jou.init_state((3,)), jax.random.key(0), []
  jnoises = []
  for _ in range(4):
    key, sub = jax.random.split(key)
    normals.append(np.asarray(jax.random.normal(sub, (3, 2))))
    jstate, noise = jou.step(jstate, sub)
    jnoises.append(noise)
  draws = ReplayDraws({"ou_noise": normals})
  tstate = tou.init_state((3,), device="cpu")
  for jn in jnoises:
    tstate, noise = tou.step(tstate, draws)
    assert_close(noise, jn, 1e-6, 1e-7)
