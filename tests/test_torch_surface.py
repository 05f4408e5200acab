"""Port parity of the public surface that `test_every_jax_public_name_has_a
_port_twin` (tests/test_torch_imports.py) found missing: the step-type
predicates and `restart(reward_spec=)`, the spec constructors, the nest
functions, `index_with_actions(multi_dim_actions=)`, `replicate`, the
public `Distribution` base, `ActorPolicy(emit_log_probability=)`,
`update(outer_dims=)`, `DequeState.add/add_where`, `Agent.loss` and
`preprocess_sequence`, CQL's `critic_loss`, C51's `support`, the replay
flags and the underfill guard, the packed row layout and the Learner's
`train_fn` and `steps_per_run_call`.

The same inputs, made from a numpy seed, go through the JAX function and
its port twin on the CPU. Float32 is compared at rtol 1e-5 / atol 1e-6;
integers, booleans, shapes and nest structure exactly. The JAX tests'
own cases come first where there are some.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import distributions as jdist
from agents_tpu import networks as jnetworks
from agents_tpu.metrics import jax_metrics as jmetrics
from agents_tpu.ops import replay_gather as jrg
from agents_tpu.policies import actor_policy as jactor_policy
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.replay_buffers import uniform_replay as juniform
from agents_tpu.specs import array_spec as jspec
from agents_tpu.train.learner import Learner as JaxLearner
from agents_tpu.train.triggers import IntervalTrigger as JaxIntervalTrigger
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu.utils import nest_utils as jnest
from agents_tpu.utils import tensor_normalizer as jtn
from agents_tpu_torch import distributions as tdist
from agents_tpu_torch.agents.categorical_dqn import CategoricalDqnAgent
from agents_tpu_torch.agents.agent import first_transition
from agents_tpu_torch.bandits.agents import LinUcbAgent
from agents_tpu_torch.metrics import torch_metrics
from agents_tpu_torch.networks import (make_categorical_q_network,
                                       make_sac_actor_network)
from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import lecun_normal_
from agents_tpu_torch.ops import replay_gather as trg
from agents_tpu_torch.policies import ActorPolicy
from agents_tpu_torch.replay_buffers import PrioritizedReplay, UniformReplay
from agents_tpu_torch.replay_buffers import uniform_replay
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.train.learner import Learner
from agents_tpu_torch.train.triggers import IntervalTrigger
from agents_tpu_torch.trajectories import policy_step as tps
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, convert, nest_utils
from agents_tpu_torch.utils import tensor_normalizer as ttn
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_cql_agent import cql_agents
from test_torch_dqn_agent import _adam_agents, _convert_state
from test_torch_dqn_agent import _experiences as _dqn_experiences
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_sample_draws, jax_sac_train_draws,
                                     to_np)
from test_torch_prioritized_replay import _filled, _u
from test_torch_sac_agent import _experiences as _sac_experiences
from test_torch_sac_agent import _specs as _sac_specs
from test_torch_sac_agent import _to_jax, _to_torch, sac_agents

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CPU = dict(device="cpu")


def _t(x):
  return torch.from_numpy(np.asarray(x))


def _j(x):
  return jnp.asarray(np.asarray(x))


def assert_nests_match(port, jax_nest, rtol=RTOL, atol=ATOL):
  """Equal leaves in ``jax.tree_util``'s order (floats within the
  tolerances, other dtypes exactly) and equal leaf counts."""
  tleaves = nest_utils.flatten_sorted(port)
  jleaves = jax.tree_util.tree_leaves(jax_nest)
  assert len(tleaves) == len(jleaves)
  for t, j in zip(tleaves, jleaves):
    assert tuple(t.shape) == tuple(np.shape(j))
    assert to_np(t).dtype == np.asarray(j).dtype
    if np.issubdtype(np.asarray(j).dtype, np.floating):
      assert_close(t, j, rtol, atol)
    else:
      assert_equal(t, j)


# -- trajectories and specs ---------------------------------------------------

def test_step_type_predicates_and_replace_fields():
  rng = np.random.RandomState(0)
  st, nst = rng.randint(0, 3, (2, 40)).astype(np.int32)
  obs = rng.randn(40, 3).astype(np.float32)
  j = jts.TimeStep(_j(st), _j(st * 0.5), _j(st * 0.1), _j(obs))
  t = tts.TimeStep(_t(st), _t(st * 0.5), _t(st * 0.1), _t(obs))
  for name in ("is_first", "is_mid", "is_last"):
    assert_equal(getattr(t, name)(), getattr(j, name)())
  fields = dict(step_type=st, observation=obs, action=obs[:, 0],
                next_step_type=nst, reward=obs[:, 1], discount=obs[:, 2])
  jt = jtj.Trajectory(policy_info=(), **{k: _j(v) for k, v in
                                         fields.items()})
  tt = ttj.Trajectory(policy_info=(), **{k: _t(v) for k, v in
                                         fields.items()})
  for name in ("is_first", "is_mid", "is_last", "is_boundary"):
    assert_equal(getattr(tt, name)(), getattr(jt, name)())
  tr = tt.replace_fields(reward=_t(obs[:, 2]), discount=_t(obs[:, 1]))
  jr = jt.replace_fields(reward=_j(obs[:, 2]), discount=_j(obs[:, 1]))
  assert_nests_match(tr, jr)


REWARD_SPECS = {
    "none": lambda lib: None,
    "vector": lambda lib: lib.ArraySpec((3,), np.float32),
    "nested": lambda lib: {"b": lib.ArraySpec((2,), np.float16),
                           "a": lib.BoundedArraySpec((), np.int32, 0, 5)},
}


@pytest.mark.parametrize("batch_size", [None, 4])
@pytest.mark.parametrize("reward", list(REWARD_SPECS))
def test_restart_zeros_the_reward_spec(reward, batch_size):
  obs = np.random.RandomState(1).randn(*((batch_size or 1), 3))
  obs = obs.astype(np.float32)[0 if batch_size is None else slice(None)]
  j = jts.restart(_j(obs), batch_size, REWARD_SPECS[reward](jspec))
  t = tts.restart(_t(obs), batch_size, REWARD_SPECS[reward](tspec))
  assert_nests_match(t, j)
  if reward == "nested":
    assert list(t.reward) == ["b", "a"]    # the spec's own key order


def test_restart_of_a_nested_observation():
  obs = {"x": np.ones((2, 3), np.float32), "y": np.zeros((2,), np.int32)}
  t = tts.restart({k: _t(v) for k, v in obs.items()}, 2)
  j = jts.restart({k: _j(v) for k, v in obs.items()}, 2)
  assert_nests_match(t, j)


@pytest.mark.parametrize("shape,dtype", [((), np.float32), ((3, 2), np.int32),
                                         ((5,), np.uint8), ((1,), np.bool_)])
def test_array_spec_ndim_from_array_and_from_spec(shape, dtype):
  x = np.zeros(shape, dtype)
  jx = jspec.ArraySpec.from_array(x, name="x")
  for tx in (tspec.ArraySpec.from_array(x, name="x"),
             tspec.ArraySpec.from_array(_t(x), name="x")):
    assert (tx.shape, tx.dtype, tx.name, tx.ndim) == (
        jx.shape, jx.dtype, jx.name, jx.ndim)
  for jsrc, tsrc in ((jspec.ArraySpec(shape, dtype, "s"),
                      tspec.ArraySpec(shape, dtype, "s")),
                     (jspec.BoundedArraySpec(shape, dtype, 0, 1, "s"),
                      tspec.BoundedArraySpec(shape, dtype, 0, 1, "s"))):
    jb = jspec.BoundedArraySpec.from_spec(jsrc)
    tb = tspec.BoundedArraySpec.from_spec(tsrc, name=None)
    assert (tb.shape, tb.dtype, tb.name) == (jb.shape, jb.dtype, jb.name)
    np.testing.assert_array_equal(tb.minimum, jb.minimum)
    np.testing.assert_array_equal(tb.maximum, jb.maximum)
    assert tspec.BoundedArraySpec.from_spec(tsrc, name="n").name == "n"


# -- nest functions -----------------------------------------------------------

def _nests(rng):
  """(numpy nest, spec nests per library) of a dict and a tuple."""
  nest = {"z": rng.randn(6, 3).astype(np.float32),
          "a": (rng.randint(0, 9, (6,)).astype(np.int32),
                rng.randn(6, 2, 2).astype(np.float32))}

  def specs(lib):
    return {"z": lib.ArraySpec((3,), np.float32),
            "a": (lib.ArraySpec((), np.int32),
                  lib.ArraySpec((2, 2), np.float32))}
  return nest, specs


NEST_CASES = {
    "is_batched": lambda n, lib, s, x: n.is_batched_nested_tensors(x, s),
    "is_batched_2": lambda n, lib, s, x: n.is_batched_nested_tensors(
        x, s, num_outer_dims=2),
    "batch": lambda n, lib, s, x: n.batch_nested_tensors(x),
    "batch_specs": lambda n, lib, s, x: n.batch_nested_tensors(
        n.unbatch_nested_tensors(n.select_batch(x, slice(0, 1))), s),
    "unbatch_specs": lambda n, lib, s, x: n.unbatch_nested_tensors(
        n.select_batch(x, slice(2, 3)), s),
    "split_3": lambda n, lib, s, x: n.split_nested_tensors(x, s, 3),
    "split_at": lambda n, lib, s, x: n.split_nested_tensors(x, s, [1, 4]),
    "unstack": lambda n, lib, s, x: n.unstack_nested_tensors(x),
    "concat": lambda n, lib, s, x: n.concat_nested_tensors([x, x]),
    "has_tensors": lambda n, lib, s, x: (n.has_tensors(x),
                                         n.has_tensors({"k": 1.0})),
}


@pytest.mark.parametrize("case", list(NEST_CASES))
def test_nest_functions_match_jax(case):
  nest, specs = _nests(np.random.RandomState(2))
  tnest = nest_utils.tree_map(_t, nest)
  jnest_ = jax.tree_util.tree_map(_j, nest)
  got = NEST_CASES[case](nest_utils, tspec, specs(tspec), tnest)
  want = NEST_CASES[case](jnest, jspec, specs(jspec), jnest_)
  if isinstance(want, (bool, tuple)) and not isinstance(want, dict) and (
      all(isinstance(w, bool) for w in jax.tree_util.tree_leaves(want))):
    assert got == want
  elif isinstance(want, list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
      assert_nests_match(g, w)
  else:
    assert_nests_match(got, want)


def test_split_raises_where_jax_does():
  nest, specs = _nests(np.random.RandomState(3))
  with pytest.raises(ValueError):
    jnest.split_nested_tensors(jax.tree_util.tree_map(_j, nest),
                               specs(jspec), 4)
  with pytest.raises(ValueError):
    nest_utils.split_nested_tensors(nest_utils.tree_map(_t, nest),
                                    specs(tspec), 4)


@pytest.mark.parametrize("other", [
    lambda x: {"z": x["z"], "a": list(x["a"])},
    lambda x: {"z": x["z"]},
    lambda x: {"z": x["z"], "a": (x["a"][0],)},
    lambda x: {"q": x["z"], "a": x["a"]}])
def test_assert_same_structure_matches_jax(other):
  nest, _ = _nests(np.random.RandomState(4))
  tnest = nest_utils.tree_map(_t, nest)
  jnest_ = jax.tree_util.tree_map(_j, nest)
  jnest.assert_same_structure(jnest_, dict(reversed(list(jnest_.items()))))
  nest_utils.assert_same_structure(tnest, dict(reversed(list(
      tnest.items()))))
  with pytest.raises(ValueError):
    jnest.assert_same_structure(jnest_, other(jnest_))
  with pytest.raises(ValueError):
    nest_utils.assert_same_structure(tnest, other(tnest))


# -- utils/common -------------------------------------------------------------

def test_index_with_actions_multi_dim_jax_case():
  """tests/test_on_policy_agents.py:163-174."""
  q = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
  actions = np.asarray([[1, 2], [0, 3]], np.int32)
  out = common.index_with_actions(_t(q), _t(actions), multi_dim_actions=True)
  assert_equal(out, np.asarray([q[0, 1, 2], q[1, 0, 3]]))
  with pytest.raises(ValueError, match="rank"):
    common.index_with_actions(_t(q[..., 0]), _t(actions),
                              multi_dim_actions=True)


@pytest.mark.parametrize("outer,dims", [((5,), (3,)), ((2, 3), (4, 2)),
                                        ((7,), (2, 3, 4)), ((), (3, 2))])
def test_index_with_actions_matches_jax(outer, dims):
  rng = np.random.RandomState(len(outer) + len(dims))
  q = rng.randn(*(outer + dims)).astype(np.float32)
  actions = np.stack([rng.randint(0, d, outer) for d in dims], -1).astype(
      np.int32)
  got = common.index_with_actions(_t(q), _t(actions), multi_dim_actions=True)
  want = jcommon.index_with_actions(_j(q), _j(actions),
                                    multi_dim_actions=True)
  assert_equal(got, want)
  single = rng.randint(0, dims[-1], outer + dims[:-1]).astype(np.int32)
  assert_equal(common.index_with_actions(_t(q), _t(single)),
               jcommon.index_with_actions(_j(q), _j(single)))


def test_log_probability_and_entropy_take_an_action_spec():
  rng = np.random.RandomState(5)
  logits, loc = rng.randn(6, 4).astype(np.float32), rng.randn(6, 2)
  loc = loc.astype(np.float32)
  actions = {"c": rng.randint(0, 4, 6).astype(np.int32),
             "n": rng.randn(6, 2).astype(np.float32)}
  tspecs = {"c": tspec.BoundedArraySpec((), np.int32, 0, 3),
            "n": tspec.ArraySpec((2,), np.float32)}
  jspecs = {"c": jspec.BoundedArraySpec((), np.int32, 0, 3),
            "n": jspec.ArraySpec((2,), np.float32)}
  td = {"c": tdist.Categorical(_t(logits)),
        "n": tdist.Independent(tdist.Normal(_t(loc), torch.ones(6, 2)), 1)}
  jd = {"c": jdist.Categorical(_j(logits)),
        "n": jdist.Independent(jdist.Normal(_j(loc), jnp.ones((6, 2))), 1)}
  assert_close(common.log_probability(td, nest_utils.tree_map(_t, actions),
                                      tspecs),
               jcommon.log_probability(jd, jax.tree_util.tree_map(
                   _j, actions), jspecs), RTOL, ATOL)
  assert_close(common.entropy(td, tspecs), jcommon.entropy(jd, jspecs), RTOL,
               ATOL)


@pytest.mark.parametrize("outer", [(), (3,), (2, 4)])
def test_replicate_matches_jax(outer):
  nest, _ = _nests(np.random.RandomState(6))
  got = common.replicate(nest_utils.tree_map(_t, nest), outer)
  assert_nests_match(got, jcommon.replicate(
      jax.tree_util.tree_map(_j, nest), outer))
  leaf = nest_utils.flatten(got)[0]
  if outer:
    leaf[(0,) * len(outer)].add_(1.0)   # a copy: the other replicas stay
    assert not torch.equal(leaf[(0,) * len(outer)], leaf[(-1,) * len(outer)])


# -- distributions ------------------------------------------------------------

def test_distribution_base_and_categorical_mean():
  for base in (tdist.Distribution(), jdist.Distribution()):
    for name in ("log_prob", "entropy", "mode", "mean"):
      args = (1.0,) if name == "log_prob" else ()
      with pytest.raises(NotImplementedError):
        getattr(base, name)(*args)
  logits = np.random.RandomState(7).randn(3, 4).astype(np.float32)
  for d in (tdist.Categorical(_t(logits)), jdist.Categorical(_j(logits))):
    with pytest.raises(NotImplementedError, match="Categorical"):
      d.mean()
  for cls in (tdist.Normal, tdist.Categorical, tdist.Beta,
              tdist.Deterministic, tdist.SquashedNormal):
    assert issubclass(cls, tdist.Distribution)


# -- ActorPolicy(emit_log_probability=) --------------------------------------

def well_conditioned_rows(dist, action, log_prob, rtol=RTOL, atol=ATOL):
  """The rows whose log-probability moves by less than the tolerance
  when the action moves by one part in a million.

  A policy's log-probability is its distribution's `log_prob` of the
  sampled action, so a tanh-squashed sample goes back through atanh: near
  the bounds, or under a small scale, an ulp of the action moves it far,
  and two float32 evaluations (the JAX package's and the port's, or the
  card's and the CPU's) part for that reason alone."""
  a = action.detach().clone().requires_grad_()
  (grad,) = torch.autograd.grad(dist.log_prob(a).sum(), a)
  moved = (grad.abs() * a.detach().abs()).reshape(len(a), -1).sum(-1) * 1e-6
  return moved < atol + rtol * log_prob.abs()


@pytest.mark.parametrize("fc,batch", [((16,), 8), ((256, 256), 32)])
def test_actor_policy_emits_the_log_probability(fc, batch):
  """The SAC actor at the SAC bench point's widths on Pendulum
  observations: the sampled actions and their log-probabilities (in
  `PolicyInfo`) under the JAX policy's draws (its key split once per
  action leaf); the log-probabilities on the rows that
  `well_conditioned_rows` keeps, at least a third of them."""
  jobs = jspec.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  jact = jspec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  jnet = jnetworks.make_sac_actor_network(jobs, jact, fc_layer_params=fc)
  params = jnet.init_params(jax.random.key(1))
  jpolicy = jactor_policy.ActorPolicy(jts.time_step_spec(jobs), jact, jnet,
                                      training=True,
                                      emit_log_probability=True)
  tobs = tspec.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  tact = tspec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  tnet = make_sac_actor_network(tobs, tact, fc_layer_params=fc, **CPU)
  tnet.load_state_dict(convert.sac_actor_params_to_state_dict(
      jax.device_get(params)))
  tpolicy = ActorPolicy(tts.time_step_spec(tobs), tact, tnet, training=True,
                        emit_log_probability=True)
  rng = np.random.RandomState(8)
  theta = rng.uniform(-np.pi, np.pi, batch)
  obs = np.stack([np.cos(theta), np.sin(theta), rng.uniform(-8, 8, batch)],
                 1).astype(np.float32)
  key = jax.random.key(9)
  jstep = jpolicy.action(params, jts.restart(_j(obs), batch), (), key)
  noise = jax.random.normal(jax.random.split(key, 1)[0], (batch, 1))
  with torch.no_grad():
    tstep = tpolicy.action(tnet, tts.restart(_t(obs), batch), (),
                           ReplayDraws({"actor_noise": [noise]}))
  assert isinstance(tstep.info, tps.PolicyInfo)
  assert isinstance(jstep.info, jps.PolicyInfo)
  assert_close(tstep.action, jstep.action, RTOL, ATOL)
  lp = tstep.info.log_probability
  assert tuple(lp.shape) == (batch,)
  rows = well_conditioned_rows(
      tpolicy.distribution(tnet, tts.restart(_t(obs), batch)).action,
      tstep.action, lp)
  assert int(rows.sum()) >= batch // 3
  assert_close(lp[rows], np.asarray(jstep.info.log_probability)[
      rows.numpy()], RTOL, ATOL)
  assert ActorPolicy(tts.time_step_spec(tobs), tact, tnet).emit_log_probability \
      is False


# -- normalizer and metrics ---------------------------------------------------

@pytest.mark.parametrize("outer", [(0,), (0, 1), None])
def test_streaming_normalizer_update_takes_outer_dims(outer):
  rng = np.random.RandomState(10)
  spec_t, spec_j = tspec.ArraySpec((3,), np.float32), jspec.ArraySpec(
      (3,), np.float32)
  tnorm, jnorm = ttn.StreamingTensorNormalizer(spec_t), \
      jtn.StreamingTensorNormalizer(spec_j)
  tstate, jstate = tnorm.init("cpu"), jnorm.init()
  rank = 1 if outer is None else len(outer)
  for _ in range(3):
    x = (rng.randn(*((5, 4)[:rank] + (3,))) * 3 + 1).astype(np.float32)
    tstate = tnorm.update(tstate, _t(x), outer_dims=outer)
    jstate = jnorm.update(jstate, _j(x), outer_dims=outer)
  assert_nests_match(tstate, jstate)
  if outer is not None:
    with pytest.raises(ValueError, match="outer_dims"):
      tnorm.update(tstate, _t(np.zeros((2, 2, 2, 3), np.float32)),
                   outer_dims=outer)


@pytest.mark.parametrize("conds", [[1, 1, 0, 1, 1, 0, 1], [0, 0, 1],
                                   [1] * 9])
def test_deque_add_and_add_where_match_jax(conds):
  t = torch_metrics.DequeState.create(4, device="cpu")
  j = jmetrics.DequeState.create(4)
  for i, c in enumerate(conds):
    value = float(i) * 1.5 - 2.0
    if i % 3 == 0:
      t, j = t.add(value), j.add(value)
    else:
      t = t.add_where(torch.tensor(bool(c)), value)
      j = j.add_where(jnp.asarray(bool(c)), value)
    assert_close(t.data, j.data, RTOL, ATOL)
    assert int(t.count) == int(j.count)
    for name in ("mean", "max", "min"):
      assert_close(getattr(t, name)(), getattr(j, name)(), RTOL, ATOL)


def test_metric_call_is_its_update():
  metric = torch_metrics.NumberOfEpisodes()
  assert torch_metrics.Metric.result_kind == "scalar"
  traj = ttj.Trajectory(
      step_type=torch.tensor([1, 1]), observation=torch.zeros(2),
      action=torch.zeros(2), policy_info=(),
      next_step_type=torch.tensor([2, 1]), reward=torch.zeros(2),
      discount=torch.ones(2))
  state = metric.init(2, device="cpu")
  assert int(metric(state, traj)) == int(metric.update(state, traj)) == 1


# -- agents -------------------------------------------------------------------

def _snapshot(state):
  """Every tensor, optimizer state, number and replayed-draw count of an
  agent state, copied."""
  out = {}
  for f in dataclasses.fields(state):
    v = getattr(state, f.name)
    if isinstance(v, torch.nn.Module):
      out[f.name] = {k: x.clone() for k, x in v.state_dict().items()}
    elif isinstance(v, torch.optim.Optimizer):
      out[f.name] = copy.deepcopy(v.state_dict())
    elif isinstance(v, torch.Tensor):
      out[f.name] = v.detach().clone()
    elif isinstance(v, ReplayDraws):
      out[f.name] = v.remaining()
    else:
      out[f.name] = v
  return out


def _assert_snapshots_equal(a, b):
  assert a.keys() == b.keys()
  for k in a:
    x, y = a[k], b[k]
    flat_x = jax.tree_util.tree_leaves(x)
    flat_y = jax.tree_util.tree_leaves(y)
    assert len(flat_x) == len(flat_y), k
    for u, v in zip(flat_x, flat_y):
      if isinstance(u, torch.Tensor):
        assert torch.equal(u, v), k
      else:
        assert u == v, k


def test_dqn_loss_matches_jax_and_leaves_the_state():
  jagent, tagent = _adam_agents(period=1)
  exps = _dqn_experiences(2)
  to_j = lambda e: jtj.Trajectory(policy_info=(), **{  # noqa: E731
      k: jnp.asarray(v) for k, v in e.items()})
  jstate, _ = jax.jit(jagent.train)(jagent.init(jax.random.key(0)),
                                    to_j(exps[0]))
  tstate = _convert_state(jstate, tagent)
  before = _snapshot(tstate)
  info = tagent.loss(tstate, _to_torch(exps[1]))
  jinfo = jagent.loss(jstate, to_j(exps[1]))
  _assert_snapshots_equal(_snapshot(tstate), before)
  assert_close(info.loss, jinfo.loss, RTOL, ATOL)
  assert_close(info.extra.td_error, jinfo.extra.td_error, RTOL, ATOL)
  _, trained = tagent.train(tstate, _to_torch(exps[1]))
  assert torch.equal(trained.loss, info.loss)
  assert tagent.preprocess_sequence(tstate, exps[1]) is exps[1]
  assert jagent.preprocess_sequence(jstate, exps[1]) is exps[1]


def test_sac_loss_takes_the_draws_that_train_takes():
  """A loss on an agent whose state carries its draw source takes a copy
  of it: the draws left over are untouched, and the train step after it
  draws the same values and gives the same loss."""
  jagent, tagent = sac_agents((16,), (16,))
  asp = _sac_specs(jspec)[1]
  draws = ReplayDraws(jax_sac_train_draws(0, 32, asp))
  jstate = jagent.init(jax.random.key(0))
  tstate = convert.load_sac_agent_state(
      tagent.init(draws=draws),
      convert.sac_agent_state_to_torch(jax.device_get(jstate)))
  e = _sac_experiences(1, seed=11)[0]
  before = _snapshot(tstate)
  info = tagent.loss(tstate, _to_torch(e))
  _assert_snapshots_equal(_snapshot(tstate), before)
  jinfo = jagent.loss(jstate, _to_jax(e))
  for name in ("critic_loss", "actor_loss", "alpha_loss"):
    assert_close(getattr(info.extra, name), getattr(jinfo.extra, name),
                 RTOL, 1e-5)
  _, trained = tagent.train(tstate, _to_torch(e))
  assert torch.equal(trained.loss, info.loss)
  assert all(v == 0 for v in draws.remaining().values())


@pytest.mark.parametrize("entropy_term,noise", [(False, 0.0), (True, 0.0),
                                                (True, 0.5)])
def test_cql_critic_loss_matches_jax(entropy_term, noise):
  """CQL's `critic_loss` is SAC's TD loss with the entropy term only under
  `include_critic_entropy_term` and the reward noise (:154-186), not the
  SAC agent's, which always has the entropy term."""
  jagent, tagent = cql_agents(include_critic_entropy_term=entropy_term,
                              reward_noise_variance=noise)
  jstate = jagent.init(jax.random.key(3))
  e = _sac_experiences(1, seed=12)[0]
  tstate = convert.load_cql_sac_agent_state(
      tagent.init(), convert.cql_sac_agent_state_to_torch(
          jax.device_get(jstate)))
  jtr = jtj.to_transition(_to_jax(e))
  first = lambda nest: jax.tree_util.tree_map(  # noqa: E731
      lambda x: x[:, 0], nest)
  key = jax.random.key(5)
  expected = jagent.critic_loss(
      (jstate.critic1_params, jstate.critic2_params), jstate,
      first(jtr.time_step), first(jtr.action_step.action),
      first(jtr.next_time_step), key)
  k_actions, k_noise = jax.random.split(key)
  records = {"cql_next_action_noise": [jax.random.normal(
      jax.random.split(k_actions, 1)[0], (32, 1))]}
  if noise:
    records["cql_reward_noise"] = [jax.random.normal(k_noise, (32,))]
  tstate = dataclasses.replace(tstate, draws=ReplayDraws(records))
  ts, actions, next_ts = first_transition(_to_torch(e), "test")
  with torch.no_grad():
    got = tagent.critic_loss(tstate, ts, actions, next_ts)
  assert_close(got, expected, RTOL, 1e-5)


def test_categorical_dqn_support():
  from agents_tpu.agents.categorical_dqn import \
      CategoricalDqnAgent as JaxC51
  jobs = jspec.ArraySpec((4,), np.float32)
  jact = jspec.BoundedArraySpec((), np.int32, 0, 1)
  jagent = JaxC51(jts.time_step_spec(jobs), jact,
                  jnetworks.make_categorical_q_network(
                      jobs, jact, num_atoms=7, fc_layer_params=(8,)),
                  None, min_q_value=-3.0, max_q_value=5.0)
  tobs = tspec.ArraySpec((4,), np.float32)
  tact = tspec.BoundedArraySpec((), np.int32, 0, 1)
  tagent = CategoricalDqnAgent(
      tts.time_step_spec(tobs), tact,
      make_categorical_q_network(tobs, tact, num_atoms=7,
                                 fc_layer_params=(8,), **CPU),
      torch.optim.Adam, min_q_value=-3.0, max_q_value=5.0, **CPU)
  assert_close(tagent.support, jagent.support, RTOL, ATOL)


def test_linear_bandit_agent_takes_its_mesh():
  tss = tts.time_step_spec(tspec.ArraySpec((2,), np.float32))
  act = tspec.BoundedArraySpec((), np.int32, 0, 2)
  assert LinUcbAgent(tss, act, **CPU).mesh is None
  marker = object()
  assert LinUcbAgent(tss, act, mesh=marker, **CPU).mesh is marker


# -- replay -------------------------------------------------------------------

SPEC = {"x": tspec.ArraySpec((), np.int32)}
JSPEC = {"x": jspec.ArraySpec((), np.int32)}


def _fill(replay, state, values, to):
  for v in values:
    state = replay.add_batch(state, {"x": to(np.asarray(
        [v * 10 + r for r in range(replay.batch_size)], np.int32))})
  return state


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("cls", [UniformReplay, PrioritizedReplay])
def test_underfill_guard_raises_as_in_jax(cls, debug):
  """tests/test_replay.py:108-139: ValueError "underfilled" below
  num_steps frames, with or without `debug_min_size_asserts`; exactly
  num_steps frames sample."""
  replay = cls(SPEC, batch_size=2, max_length=8,
               debug_min_size_asserts=debug, **CPU)
  assert replay.debug_min_size_asserts is debug
  state = replay.init()
  draws = ReplayDraws({})
  with pytest.raises(ValueError, match="underfilled"):
    replay.sample(state, draws, 4)
  state = _fill(replay, state, range(1), _t)
  with pytest.raises(ValueError, match="underfilled"):
    replay.sample(state, draws, 4, num_steps=2)
  state = _fill(replay, state, range(1, 2), _t)
  site = {UniformReplay: {"replay_t0": [np.zeros(4, np.int64)],
                          "replay_rows": [np.ones(4, np.int64)]},
          PrioritizedReplay: {"per_u": [np.full(4, 0.5, np.float32)]}}[cls]
  replay.sample(state, ReplayDraws(site), 4, num_steps=2)


@pytest.mark.parametrize("count,n", [(0, 1), (3, 4), (4, 4), (9, 2)])
def test_check_min_size_matches_jax(count, n):
  for check, c in ((uniform_replay.check_min_size, count),
                   (juniform.check_min_size, jnp.int32(count))):
    if count < n:
      with pytest.raises(ValueError, match="underfilled"):
        check(c, n)
    else:
      check(c, n, True)


@pytest.mark.parametrize("num_steps,frames", [(None, 5), (2, 13), (3, 30)])
def test_sort_for_locality_matches_jax(num_steps, frames):
  """The sorted sample's ids, rows and batch equal the JAX buffer's under
  the same draws (including a wrapped ring)."""
  B, CAP, S = 3, 8, 16
  jrb = JaxUniformReplay(JSPEC, B, CAP, sort_for_locality=True)
  trb = UniformReplay(SPEC, B, CAP, sort_for_locality=True, **CPU)
  js = _fill(jrb, jrb.init(), range(frames), jnp.asarray)
  ts = _fill(trb, trb.init(), range(frames), _t)
  key = jax.random.key(frames)
  jb, ji = jrb.sample(js, key, S, num_steps=num_steps)
  n = 1 if num_steps is None else num_steps
  num_valid = min(frames, CAP) - n + 1
  tb, ti = trb.sample(ts, ReplayDraws(jax_sample_draws(key, S, num_valid,
                                                       B)), S,
                      num_steps=num_steps)
  assert_equal(ti.ids, ji.ids)
  assert_equal(ti.rows, ji.rows)
  assert_close(ti.probabilities, ji.probabilities, RTOL, ATOL)
  assert_equal(tb["x"], jb["x"])
  flat = to_np(ti.ids) * B + to_np(ti.rows)
  assert np.all(np.diff(flat) >= 0)


def test_per_raw_is_weights_match_jax():
  rng = np.random.RandomState(13)
  jside, tside = _filled(4, 8, 11, 1.0, 0.0, rng,
                         lambda r, b: r.randint(1, 9, b).astype(np.float32))
  (jrb, js), (trb, ts) = jside, tside
  key = jax.random.key(14)
  weights = {}
  for normalize in (True, False):
    _, ji = jrb.sample(js, key, 6, beta=0.6,
                       _normalize_is_weights=normalize)
    _, ti = trb.sample(ts, ReplayDraws({"per_u": [_u(key, 6)]}), 6,
                       beta=0.6, _normalize_is_weights=normalize)
    assert_equal(ti.ids, ji.ids)
    assert_close(ti.is_weights, ji.is_weights, 1e-6, ATOL)
    weights[normalize] = ti.is_weights
  assert float(weights[True].max()) == 1.0
  assert float(weights[False].max()) < 1.0     # the raw (N p)^-beta
  assert_close(weights[False] / weights[False].max(), weights[True], 1e-6,
               ATOL)


# -- the packed row layout (tests/test_pallas_ops.py) ------------------------

@pytest.mark.parametrize("f,dtype", [(256, np.float32), (300, np.uint8),
                                     (28224, np.uint8), (5, np.float32)])
def test_pack_unpack_roundtrip(f, dtype):
  x = np.arange(7 * f).reshape(7, f).astype(dtype)
  p = trg.pack_rows(_t(x))
  jp = jrg.pack_rows(_j(x))
  assert tuple(p.shape) == tuple(jp.shape) == (7,) + jrg.packed_row_shape(
      f, dtype)
  assert trg.packed_row_shape(f, dtype) == jrg.packed_row_shape(f, dtype)
  assert_equal(p, jp)
  assert_equal(trg.unpack_rows(p, f), x)


def test_packed_row_shape_and_should_pack_match_jax():
  for f, dtype in ((28224, np.uint8), (256, np.float32), (1, np.float64),
                   (129, np.float16)):
    assert trg.packed_row_shape(f, dtype) == jrg.packed_row_shape(f, dtype)
  assert trg.packed_row_shape(28224, torch.uint8) == (224, 128)
  for shape, dtype in (((84, 84, 4), np.uint8), ((4,), np.float32),
                       ((2048,), np.float32), ((1023,), np.float32)):
    assert trg.should_pack(shape, dtype) == jrg.should_pack(shape, dtype)


def test_row_packer_mixed_nest():
  """tests/test_pallas_ops.py:48-72, on both packages."""
  def spec(lib):
    return {"state": lib.ArraySpec((4,), np.float32),
            "frames": lib.ArraySpec((84, 84, 4), np.uint8)}
  packer, jpacker = trg.RowPacker(spec(tspec), **CPU), jrg.RowPacker(
      spec(jspec))
  assert packer.any_packed and packer.packed == jpacker.packed
  storage = packer.init_storage((6, 3))
  flat = packer.flatten(storage)       # jax.tree_util's order
  assert tuple(flat[0].shape) == (6, 3, 224, 128)
  assert tuple(flat[1].shape) == (6, 3, 4)
  assert list(storage) == ["state", "frames"]
  items = {"state": np.ones((3, 4), np.float32),
           "frames": np.arange(3 * 84 * 84 * 4).reshape(
               3, 84, 84, 4).astype(np.uint8)}
  stored = packer.to_stored(nest_utils.tree_map(_t, items), outer_ndim=1)
  jstored = jpacker.to_stored(jax.tree_util.tree_map(_j, items), 1)
  assert_nests_match(stored, jstored)
  back = packer.from_stored(stored, outer_ndim=1)
  assert_nests_match(back, items)
  assert not trg.RowPacker(spec(tspec), enabled=False, **CPU).any_packed


# -- the Learner's train_fn and steps_per_run_call --------------------------

class _Writer:

  def __init__(self):
    self.steps = []

  def scalar(self, name, value, step):
    if name == "loss":
      self.steps.append((int(step), float(value)))


def _learner_run(cls, trigger_cls, root, zero, arange, calls):
  fired, writer = [], _Writer()
  learner = cls(root, initial_state=zero,
                train_fn=lambda s, n: (s + n, arange(n) + s),
                triggers=[trigger_cls(10, lambda: fired.append(
                    learner.global_step))],
                checkpoint_interval=0, steps_per_run_call=4,
                summary_writer=writer, summary_interval=12)
  losses = [learner.run(n) for n in calls]
  return learner.global_step, fired, writer.steps, losses, float(
      learner.state)


def test_learner_steps_per_run_call_matches_jax(tmp_path):
  """`global_step` advances by iterations * steps_per_run_call, and the
  triggers and summaries fire at the JAX Learner's steps."""
  calls = [1, 2, 1, 3, 1, 1, 5, 2]
  jax_run = _learner_run(
      JaxLearner, JaxIntervalTrigger, str(tmp_path / "jax"),
      jnp.zeros((), jnp.float32),
      lambda n: jnp.arange(n, dtype=jnp.float32), calls)
  port_run = _learner_run(
      Learner, IntervalTrigger, str(tmp_path / "port"),
      torch.zeros((), dtype=torch.float32),
      lambda n: torch.arange(n, dtype=torch.float32), calls)
  assert port_run == jax_run
  assert port_run[0] == 4 * sum(calls)


def test_learner_checkpoints_at_the_scaled_step(tmp_path):
  state = {"x": torch.zeros(())}
  learner = Learner(str(tmp_path), initial_state=state,
                    train_fn=lambda s, n: ({"x": s["x"] + n},
                                           torch.zeros(n)),
                    checkpoint_interval=8, steps_per_run_call=3)
  for n in (1, 2, 1, 3):
    learner.run(n)
  fires, trigger = [], JaxIntervalTrigger(8, lambda: None)
  step = 0
  for n in (1, 2, 1, 3):
    step += 3 * n
    if trigger(step):
      fires.append(step)
  assert learner.checkpointer.all_steps() == fires == [9, 21]


# -- networks -----------------------------------------------------------------

def test_network_init_state_and_copy():
  from agents_tpu_torch.networks import make_q_rnn_network
  obs = tspec.ArraySpec((3,), np.float32)
  act = tspec.BoundedArraySpec((), np.int32, 0, 1)
  net = make_q_rnn_network(obs, act, input_fc_layer_params=(4,),
                           lstm_size=5, **CPU)
  jnet = jnetworks.make_q_rnn_network(
      jspec.ArraySpec((3,), np.float32),
      jspec.BoundedArraySpec((), np.int32, 0, 1),
      input_fc_layer_params=(4,), lstm_size=5)
  for batch in (None, 2):
    assert_nests_match(net.init_state(batch), jnet.init_state(batch))
  twin = net.copy()
  for (k, a), (_, b) in zip(net.state_dict().items(),
                            twin.state_dict().items()):
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k


def test_encoder_kernel_init():
  spec = tspec.ArraySpec((6,), np.float32)
  gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
  default = EncoderModule(spec, fc_layer_params=(8,), generator=gen(), **CPU)
  same = EncoderModule(spec, fc_layer_params=(8,), generator=gen(), **CPU)
  lecun = EncoderModule(spec, fc_layer_params=(8,), generator=gen(),
                        kernel_init=lecun_normal_, **CPU)
  w0, w1, w2 = (m.layers[0].weight for m in (default, same, lecun))
  assert torch.equal(w0, w1)
  # variance_scaling(2.0) against (1.0): the same draws scaled by sqrt 2.
  assert_close(w0, w2 * np.sqrt(2.0), RTOL, ATOL)
