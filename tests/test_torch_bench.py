"""`bench_torch.py`, the port's twin of `bench.py`, on the CPU.

- Its operating points are `bench.py`'s: each keyword of `bench.py`'s calls
  (agents, replays, loops, networks; read by `ast`, the JAX default where
  it passes none) against the twin's loops as the examples build them;
  the calls the twin makes itself literal for literal; chunk counts,
  capacities, shapes and the SAC ramp. A drift on either side fails.
- Its bench-point loop and its pixel loop (at `bench.py`'s smoke shapes)
  against the JAX loops built as `bench.py` builds them, from the same
  params and the same draws (the JAX loops' own key splits, replayed):
  losses, replay and params after 3 iterations at rtol 1e-5 / atol 1e-6;
  the pixel loop in bfloat16 at the bf16 Q tolerance (atol 1e-2), and in
  float32 at the conv loop's rtol 1e-5 / atol 1e-5, which a missing or
  mis-set Adam step would break.
- Its analytic FLOP count is `bench.py`'s.
- ``main(["--device", "cpu", "--smoke"])`` prints one line with the twin's
  keys, `value` 0 and the smoke's cuts; `chip_smoke.py`'s `bench` checks
  pass on it and fail on a broken line.
- The SAC probe over HalfCheetah-v5 (gymnasium and MuJoCo) and over its
  stand-in when MuJoCo is absent.
- Without a card, the default device raises.
"""
import ast
import contextlib
import copy
import importlib.util
import inspect
import io
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench_torch
import chip_smoke
from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.agents.sac import SacAgent as JaxSacAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.classic.synthetic_pixels import \
    SyntheticPixels as JaxSyntheticPixels
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import AsyncHostDeviceTrainLoop as JaxAsyncLoop
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch import metrics as tmetrics
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from examples import dqn_cartpole_torch, dqn_pixels_torch
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_env_reset_draws,
                                     jax_sample_draws, merge_draws)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 3
BF16_ATOL = 1e-2
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


# -- operating points: bench.py's literals against the twin's loops ----------


def _function(path, name):
  tree = ast.parse(open(os.path.join(ROOT, path)).read())
  return next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)


# The port's names of the JAX keywords.
RENAMED = {"actor_optimizer": "actor_optimizer_fn",
           "critic_optimizer": "critic_optimizer_fn",
           "alpha_optimizer": "alpha_optimizer_fn"}
PREPROCESSING_PROBE = np.array([0, 51, 255], np.uint8)


def _norm(node, names):
  """A `bench.py` expression as a value: `names` for the variables it
  reads, literals and arithmetic on them; an attribute by its name
  (``jnp.bfloat16``: "bfloat16"); a lambda by its dtype and outputs on
  `PREPROCESSING_PROBE`; a call as (callee, literal positional arguments,
  keywords)."""
  if isinstance(node, (ast.Name, ast.BinOp, ast.Constant, ast.Tuple)):
    try:
      return eval(compile(ast.Expression(node), "bench.py", "eval"), {},
                  names)
    except NameError:
      pass
  if isinstance(node, ast.Name):
    return node.id
  if isinstance(node, ast.Attribute):
    return node.attr
  if isinstance(node, ast.Lambda):
    fn = eval(compile(ast.Expression(node), "bench.py", "eval"),
              {"jnp": jnp})
    out = fn(jnp.asarray(PREPROCESSING_PROBE))
    return (str(out.dtype), np.asarray(out, np.float32).tolist())
  if isinstance(node, ast.List):
    return [_norm(e, names) for e in node.elts]
  if isinstance(node, ast.Call):
    literals = []
    for a in node.args:
      with contextlib.suppress(ValueError):
        literals.append(ast.literal_eval(a))
    return (_norm(node.func, names), literals,
            {RENAMED.get(k.arg, k.arg): _norm(k.value, names)
             for k in node.keywords})
  return ast.unparse(node)


def _calls(function, callee, names=None):
  """Every call of `callee` in `function`, normalized."""
  return [_norm(n, names or {}) for n in ast.walk(function)
          if isinstance(n, ast.Call) and _norm(n.func, {}) == callee]


def _assigned(function, *names):
  """The value node assigned to `names` in `function`."""
  for node in ast.walk(function):
    if not isinstance(node, ast.Assign):
      continue
    target = node.targets[0]
    elts = target.elts if isinstance(target, ast.Tuple) else [target]
    if [ast.unparse(e) for e in elts] == list(names):
      return node.value
  raise KeyError(names)


def _smoke_or_full(function, *names, smoke, scope=None):
  """`names`' values in `bench.py`'s ``X if smoke else Y``."""
  node = _assigned(function, *names)
  values = _norm(node.body if smoke else node.orelse, scope or {})
  return dict(zip(names, values)) if len(names) > 1 else {names[0]: values}


def _loop_iters(function):
  """The sources of every ``for`` loop's iterable in `function`."""
  return [ast.unparse(n.iter) for n in ast.walk(function)
          if isinstance(n, ast.For)]


def _defaults(fn):
  return {k: p.default for k, p in inspect.signature(fn).parameters.items()
          if p.default is not inspect.Parameter.empty}


def _jax_defaults(fn):
  """`fn`'s defaults under the port's names; functions and dtypes by
  name."""
  return {RENAMED.get(k, k): getattr(v, "__name__", v)
          for k, v in _defaults(fn).items()}


def _bench_names(function):
  """The values `bench.py`'s full run gives the names its calls read."""
  fn = _function("bench.py", function)
  if function == "conv_bench":
    max_length = _ast_defaults(fn)["max_length"]
    return _smoke_or_full(fn, "B", "SAMPLE", "CAPACITY", smoke=False,
                          scope={"max_length": max_length})
  return {"B": _norm(_assigned(fn, "B"), {})}


def _ast_defaults(function):
  """A `bench.py` function's keyword defaults, read by `ast`."""
  args = function.args
  return {a.arg: ast.literal_eval(d) for a, d in zip(args.args[::-1],
                                                      args.defaults[::-1])}


def _optimizer(fn):
  """A port optimizer factory as `bench.py` writes it: ``adam(lr)`` or
  ``adam(lr, eps=...)``."""
  opt = fn([torch.zeros(1, requires_grad=True)])
  d = opt.defaults
  assert type(opt) is torch.optim.Adam and d["betas"] == (0.9, 0.999)
  return ("adam", [d["lr"]], {} if d["eps"] == 1e-8 else {"eps": d["eps"]})


def _collect_metrics(metrics):
  """A loop's metrics as `bench.py` writes them."""
  def kinds(ms):
    return [(type(m).__name__, getattr(m, "buffer_size", None)) for m in ms]
  n = metrics[2].buffer_size
  if kinds(metrics) == kinds(tmetrics.standard_collect_metrics(n)):
    return ("standard_collect_metrics", [n], {})
  return kinds(metrics)


def _network(net):
  """A port network as `bench.py`'s factory call: (factory, [], kwargs)."""
  config = net.build_config
  return (config["factory"], [], config["kwargs"])


def _q_network(net):
  enc = net.encoder
  pre = None
  if enc.preprocessing is not None:
    out = enc.preprocessing(torch.from_numpy(PREPROCESSING_PROBE))
    pre = (str(out.dtype).removeprefix("torch."), out.float().tolist())
  return {
      "conv_layer_params": tuple((c.out_channels, c.kernel_size[0],
                                  c.stride[0]) for c in enc.convs),
      "fc_layer_params": tuple(lin.out_features for lin in enc.layers),
      "dtype": str(net.dtype).removeprefix("torch."),
      "preprocessing": pre}


# Per `bench.py` callee: the JAX callable whose defaults fill what
# `bench.py` leaves out, and the twin's value of each keyword, read from
# its built loop (`widths` overrides what the CPU build cuts).
TWIN = {
    "make_q_network": (jnetworks.make_q_network,
                       lambda loop, w: _q_network(loop.agent.q_network)),
    "DqnAgent": (JaxDqnAgent.__init__, lambda loop, w: {
        "optimizer": _optimizer(loop.agent.optimizer_fn),
        "epsilon_greedy": loop.agent.epsilon_greedy,
        "n_step_update": loop.agent.n_step_update,
        "td_errors_loss_fn": loop.agent.td_errors_loss_fn.__name__,
        "gamma": loop.agent.gamma,
        "reward_scale_factor": loop.agent.reward_scale_factor,
        "target_update_tau": loop.agent.target_update_tau,
        "target_update_period": loop.agent.target_update_period,
        "gradient_clipping": loop.agent.gradient_clipping}),
    "UniformReplay": (JaxUniformReplay.__init__, lambda loop, w: {
        "batch_size": loop.replay.batch_size,
        "max_length": w.get("max_length", loop.replay.capacity)}),
    "FusedTrainLoop": (JaxFusedTrainLoop.__init__, lambda loop, w: {
        "metrics": _collect_metrics(loop.metrics),
        "collect_steps_per_iteration": loop.collect_steps,
        "sample_batch_size": loop.sample_batch_size,
        "train_steps_per_iteration": loop.train_steps}),
    "SacAgent": (JaxSacAgent.__init__, lambda loop, w: {
        "critic_network": _network(loop.agent.critic_network),
        "actor_network": _network(loop.agent.actor_network),
        "actor_optimizer_fn": _optimizer(loop.agent.actor_optimizer_fn),
        "critic_optimizer_fn": _optimizer(loop.agent.critic_optimizer_fn),
        "alpha_optimizer_fn": _optimizer(loop.agent.alpha_optimizer_fn),
        "target_update_tau": loop.agent.target_update_tau,
        "target_update_period": loop.agent.target_update_period,
        "gamma": loop.agent.gamma,
        "reward_scale_factor": loop.agent.reward_scale_factor,
        "td_errors_loss_fn": loop.agent.td_errors_loss_fn.__name__,
        "gradient_clipping": loop.agent.gradient_clipping}),
    "AsyncHostDeviceTrainLoop": (JaxAsyncLoop.__init__, lambda loop, w: {
        "sample_batch_size": loop.sample_batch_size,
        "train_steps_per_call": loop.train_steps_per_call,
        "utd_ratio": loop.utd_ratio,
        "min_replay_frames": loop.min_replay_frames,
        "py_metrics": [(type(m).__name__, [], {}) for m in loop.py_metrics]}),
}


def cartpole_loop(fields):
  """`bench_point`'s loop, `examples/dqn_cartpole_torch.py`'s, on the CPU."""
  return dqn_cartpole_torch.build_loop(dqn_cartpole_torch.Config(
      **fields, device="cpu"))


def pixel_loop(**fields):
  """`conv_bench`'s loop, `examples/dqn_pixels_torch.py`'s, on the CPU."""
  return dqn_pixels_torch.build_loop(dqn_pixels_torch.Config(
      **fields, device="cpu"))


@pytest.fixture(scope="module")
def twin_loops():
  """The twin's loops, built on the CPU: the bench point at full width;
  the pixel point at full width but a ring of 2 per row (the 2,048 of the
  full run would take 7.4 GB); the SAC probe's over its stand-in envs."""
  sac = bench_torch.sac_loop(torch.device("cpu"),
                             bench_torch.random_halfcheetah)
  sac.env.close()
  return {
      "main": (cartpole_loop(bench_torch.BENCH_POINT), {}),
      "conv_bench": (pixel_loop(replay_capacity=2), {
          "max_length": _defaults(bench_torch.conv_bench)["max_length"]}),
      "sac_live_probe": (sac, {}),
  }


@pytest.mark.parametrize("function, callee", [
    ("main", "make_q_network"), ("main", "DqnAgent"),
    ("main", "UniformReplay"), ("main", "FusedTrainLoop"),
    ("conv_bench", "make_q_network"), ("conv_bench", "DqnAgent"),
    ("conv_bench", "UniformReplay"), ("conv_bench", "FusedTrainLoop"),
    ("sac_live_probe", "SacAgent"), ("sac_live_probe", "UniformReplay"),
    ("sac_live_probe", "AsyncHostDeviceTrainLoop")])
def test_loop_matches_bench_py_call(twin_loops, function, callee):
  """Each keyword of `bench.py`'s call (the JAX default where it passes
  none) against the twin's loop as built."""
  fn = _function("bench.py", function)
  [(_, _, kwargs)] = _calls(fn, callee, _bench_names(function))
  if callee == "DqnAgent":
    [call] = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
              and _norm(n.func, {}) == callee]
    kwargs["optimizer"] = _norm(call.args[3], {})
  jax_fn, twin = TWIN[callee]
  loop, widths = twin_loops[function]
  actual = twin(loop, widths)
  assert set(kwargs) <= set(actual)
  defaults = _jax_defaults(jax_fn)
  expected = {k: kwargs[k] if k in kwargs else defaults[k] for k in actual}
  assert actual == expected


@pytest.mark.parametrize("function, callee", [
    ("sac_live_probe", "run"),
    ("host_atari_replay_probe", "PyUniformReplayBuffer"),
    ("host_atari_replay_probe", "PyHashedReplayBuffer"),
    ("host_atari_replay_probe", "sample")])
def test_own_calls_match_bench_py(function, callee):
  """The calls the twin makes itself, literal for literal."""
  expected = _calls(_function("bench.py", function), callee)
  actual = _calls(_function("bench_torch.py", function), callee)
  assert expected and all(call in actual for call in expected)


@pytest.mark.parametrize("jax_function, twin_function", [
    ("main", "bench_point"), ("conv_bench", "conv_bench")])
def test_initial_collect_matches_bench_py(jax_function, twin_function):
  def steps(path, name):
    return [c[2]["initial_collect_steps"] for c in _calls(
        _function(path, name), "init")]

  assert steps("bench_torch.py", twin_function) == steps(
      "bench.py", jax_function) != []


def test_bench_point_depth_matches_bench_py():
  main = _function("bench.py", "main")
  depth = _norm(_assigned(main, "CHUNK", "N_TIMED"), {})
  warmup = [s for s in _loop_iters(main) if s.startswith("range(")][0]
  warmup = ast.literal_eval(warmup[len("range("):-1])
  assert _defaults(bench_torch.bench_point) == dict(
      device="cuda", chunk=depth[0], warmup_chunks=warmup,
      timed_chunks=depth[1])
  assert bench_torch.BENCH_POINT["env_batch_size"] == _bench_names(
      "main")["B"]
  # The pixel bench's capacities.
  capacities = [s for s in _loop_iters(main) if s.startswith("(")]
  assert capacities == [str(bench_torch.CONV_CAPACITIES)]


def test_conv_bench_shapes_and_depth_match_bench_py():
  """The full run's widths are the pixel example's default Config; the
  smoke's are `CONV_CPU_SMOKE` on the CPU; the chunks and warm-up are
  `conv_bench`'s defaults and `SMOKE`'s."""
  Config = dqn_pixels_torch.Config
  theirs = _function("bench.py", "conv_bench")
  defaults = _defaults(bench_torch.conv_bench)
  [size_node] = [k.value for n in ast.walk(theirs) if isinstance(n, ast.Call)
                 and _norm(n.func, {}) == "SyntheticPixels"
                 for k in n.keywords if k.arg == "size"]
  assert _norm(size_node.orelse, {}) == Config().pixels_size
  assert _norm(size_node.body, {}) == bench_torch.CONV_CPU_SMOKE[
      "pixels_size"]
  full = _smoke_or_full(theirs, "B", "SAMPLE", "CAPACITY", smoke=False,
                        scope={"max_length": defaults["max_length"]})
  assert full == {"B": Config().env_batch_size,
                  "SAMPLE": Config().sample_batch_size,
                  "CAPACITY": defaults["max_length"]}
  smoke = _smoke_or_full(theirs, "B", "SAMPLE", "CAPACITY", smoke=True)
  assert smoke == {"B": bench_torch.CONV_CPU_SMOKE["env_batch_size"],
                   "SAMPLE": bench_torch.CONV_CPU_SMOKE["sample_batch_size"],
                   "CAPACITY": bench_torch.CONV_CPU_SMOKE["replay_capacity"]}
  for smoke, depth in ((False, defaults), (True, bench_torch.SMOKE[
      "conv_bench"])):
    chunks = _smoke_or_full(theirs, "CHUNK", "N_TIMED", smoke=smoke)
    assert (chunks["CHUNK"], chunks["N_TIMED"]) == (depth["chunk"],
                                                    depth["timed_chunks"])
  warmup = [s for s in _loop_iters(theirs) if s.startswith("range(")][0]
  assert defaults["warmup_chunks"] == int(warmup[len("range("):-1])
  assert defaults["max_length"] == _ast_defaults(theirs)["max_length"]


def test_sac_probe_ramp_and_window_match_bench_py():
  ours, theirs = (_function(p, "sac_live_probe") for p in ("bench_torch.py",
                                                           "bench.py"))
  assert _bench_names("sac_live_probe")["B"] == bench_torch.SAC_POINT[
      "env_batch_size"] == 32
  ramp = [s for s in _loop_iters(theirs) if s.startswith("range(1, ")]
  assert ramp == ["range(1, 7)"]
  defaults = _defaults(bench_torch.sac_live_probe)
  assert defaults["max_ramp_runs"] == 6
  assert ast.unparse(_assigned(theirs, "ticks")) == ast.unparse(
      _assigned(ours, "ticks")).replace("SAC_MIN_TICKS",
                                        str(bench_torch.SAC_MIN_TICKS))
  assert defaults["seconds"] == _ast_defaults(theirs)["seconds"]

  def utd_of(function):
    return ast.unparse(next(n for n in ast.walk(function)
                            if isinstance(n, ast.FunctionDef)
                            and n.name == "utd_of"))
  assert utd_of(ours) == utd_of(theirs)


def test_host_replay_probe_depth_matches_bench_py():
  ours, theirs = (_function(p, "host_atari_replay_probe")
                  for p in ("bench_torch.py", "bench.py"))
  for name in ("CHUNK", "SAMPLES"):
    assert ast.unparse(_assigned(ours, name)) == ast.unparse(
        _assigned(theirs, name))
  assert _loop_iters(ours) == _loop_iters(theirs)
  jax_defaults = _ast_defaults(theirs)
  defaults = _defaults(bench_torch.host_atari_replay_probe)
  assert {k: defaults[k] for k in jax_defaults} == jax_defaults == dict(
      capacity=1_000_000, hashed_frames=100_000)


def test_baseline_denominators_match_bench_py():
  tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
  values = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
            if isinstance(n, ast.Assign)
            and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id.startswith("TF_AGENTS")}
  assert values == {
      "TF_AGENTS_CPU_ENV_STEPS_PER_S":
          bench_torch.TF_AGENTS_CPU_ENV_STEPS_PER_S,
      "TF_AGENTS_SAC_CPU_ENV_STEPS_PER_S":
          bench_torch.TF_AGENTS_SAC_CPU_ENV_STEPS_PER_S}


# -- the FLOP count ------------------------------------------------------------


def test_flop_count_matches_bench_py():
  """`bench.py:238-254`'s own code, run on the pixel bench's shapes."""
  conv = _function("bench.py", "conv_bench")
  fwd_def = next(n for n in conv.body if isinstance(n, ast.FunctionDef)
                 and n.name == "q_net_fwd_flops")
  scope = {"env": types.SimpleNamespace(env=types.SimpleNamespace(
      size=84, frames=4, num_actions=6))}
  exec(compile(ast.Module([fwd_def], []), "bench.py", "exec"), scope)
  fwd = scope["q_net_fwd_flops"]()
  per_iter = eval(ast.unparse(_assigned(conv, "model_flops_per_iter")),
                  {"fwd": fwd, "B": 128, "SAMPLE": 256})
  assert fwd == bench_torch.conv_forward_flops(
      84, 4, 6, bench_torch.MNIH15, (512,)) == 32_012_288
  assert per_iter == bench_torch.conv_iteration_flops(
      84, 4, 6, 128, 256) == 36_878_155_776


# -- the loops against the JAX loops --------------------------------------------


def _jax_bench_point(B):
  """`bench.py:401-415` at `B` rows."""
  env = BatchedJaxEnv(JaxCartPole(), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = jnetworks.make_q_network(tss.observation, asp,
                                  fc_layer_params=(100, 50))
  agent = JaxDqnAgent(tss, asp, qnet, optax.adam(1e-3), epsilon_greedy=0.1,
                      target_update_tau=0.05, target_update_period=5,
                      gamma=0.99,
                      td_errors_loss_fn=jcommon.element_wise_squared_loss)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), batch_size=B,
                            max_length=512)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(20),
                           collect_steps_per_iteration=1,
                           sample_batch_size=256)


def _jax_conv_bench(dtype=jnp.bfloat16):
  """`bench.py:203-221` at its smoke shapes, computing in `dtype`."""
  B, SAMPLE, CAPACITY = 8, 16, 64
  env = BatchedJaxEnv(JaxSyntheticPixels(size=20), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = jnetworks.make_q_network(
      tss.observation, asp,
      conv_layer_params=((32, 8, 4), (64, 4, 2), (64, 3, 1)),
      fc_layer_params=(512,), dtype=dtype,
      preprocessing=lambda x: x.astype(dtype) / 255.0)
  agent = JaxDqnAgent(tss, asp, qnet, optax.adam(2.5e-4, eps=1.5e-4),
                      epsilon_greedy=0.05, gamma=0.99,
                      target_update_tau=1.0, target_update_period=500,
                      td_errors_loss_fn=jcommon.element_wise_huber_loss)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), batch_size=B,
                            max_length=CAPACITY)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(20),
                           collect_steps_per_iteration=1,
                           sample_batch_size=SAMPLE)


def _run_both(jloop, tloop, initial, key=jax.random.key(0)):
  """Both loops from the JAX loop's initial params and draws: init with
  `initial` collect steps, then ITERS iterations."""
  B, capacity = jloop.env.batch_size, jloop.replay.capacity
  env, asp = jloop.env.env, jloop.env.action_spec()

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=initial)
    return state.agent_state.q_params, jloop.run(state, ITERS)

  q0, (jstate, jlosses) = jax.jit(init_and_run)(key)
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [jax_env_reset_draws(k_driver, B, env),
             jax_collect_draws(k_collect, initial, B, asp, env)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(initial + i + 1, capacity) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp, env))
    records.append(jax_sample_draws(jax.random.split(k_s, 1)[0],
                                    jloop.sample_batch_size, num_valid, B))
  tloop.agent.q_network.load_state_dict(
      convert.q_params_to_state_dict(jax.device_get(q0)))
  draws = ReplayDraws(merge_draws(*records))
  tstate = tloop.init(draws=draws, initial_collect_steps=initial)
  tstate, tlosses = tloop.run(tstate, ITERS)
  assert all(v == 0 for v in draws.remaining().values())
  return (jstate, jlosses), (tstate, tlosses)


def _assert_runs_agree(jax_run, port_run, rtol, atol):
  (jstate, jlosses), (tstate, tlosses) = jax_run, port_run
  assert_close(tlosses, jlosses, rtol=rtol, atol=atol)
  storage, jstorage = tstate.replay_state.storage, jstate.replay_state.storage
  for field in ("step_type", "observation", "action", "next_step_type",
                "reward", "discount"):
    a, b = getattr(storage, field), getattr(jstorage, field)
    if a.dtype.is_floating_point:
      assert_close(a, b, rtol=rtol, atol=atol, err_msg=field)
    else:
      assert_equal(a, b, field)
  ja = jax.device_get(jstate.agent_state)
  for tree, net in ((ja.q_params, tstate.agent_state.q_network),
                    (ja.target_q_params, tstate.agent_state.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], rtol=rtol, atol=atol, err_msg=k)
  assert tstate.agent_state.train_step == int(ja.train_step) == ITERS


def test_bench_point_loop_matches_jax():
  """The twin's bench-point loop at B=32 (the operating point's width
  cut; everything else as `bench.py:401-418`)."""
  runs = _run_both(_jax_bench_point(32),
                   cartpole_loop({**bench_torch.BENCH_POINT,
                                  "env_batch_size": 32}),
                   initial=100)
  _assert_runs_agree(*runs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype, rtol, atol", [
    ("bfloat16", 0.0, BF16_ATOL), ("float32", 1e-5, 1e-5)])
def test_conv_bench_loop_matches_jax(dtype, rtol, atol):
  """The twin's pixel loop at `bench.py`'s smoke shapes (B=8, sample 16,
  ring 64, 20x20x4): in bfloat16, as the bench runs, at the bf16 Q
  tolerance; in float32 at the conv loop's, where 3 Adam steps of about
  2.5e-4 each, and the eps of 1.5e-4, are far above the tolerance."""
  runs = _run_both(_jax_conv_bench(getattr(jnp, dtype)),
                   pixel_loop(**bench_torch.CONV_CPU_SMOKE, dtype=dtype),
                   initial=64)
  _assert_runs_agree(*runs, rtol=rtol, atol=atol)


# -- the line ------------------------------------------------------------------

DETAIL_KEYS = {
    "avg_return_last20", "timed_iterations", "batch_size",
    "train_steps_per_env_batch_step", "wall_s", "chunk_ms_per_iteration",
    "atari_conv_mnih15", "atari_host_replay_1m",
    "sac_halfcheetah_live_throughput", "card", "torch", "cuda", "tf32",
    "reduced"}


@pytest.fixture(scope="module")
def smoke_output():
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert bench_torch.main(["--device", "cpu", "--smoke"]) == 0
  return out.getvalue()


def test_smoke_main_prints_one_line_with_the_keys(smoke_output):
  lines = smoke_output.strip().splitlines()
  assert len(lines) == 1
  line = json.loads(lines[0])
  assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
  assert line["metric"] == "dqn_cartpole_fused_env_steps_per_s"
  detail = line["detail"]
  assert set(detail) == DETAIL_KEYS == chip_smoke.BENCH_DETAIL_KEYS
  assert detail["avg_return_last20"] < 195 and line["value"] == 0
  assert line["vs_baseline"] == 0
  assert detail["reduced"] == bench_torch.smoke_cuts(
      bench_torch.smoke_depths(torch.device("cpu"))) != []
  assert detail["card"] is None and detail["cuda"] is None
  assert detail["tf32"] == {"matmul": False, "cudnn": False}
  assert len(detail["chunk_ms_per_iteration"]) == 2
  assert detail["timed_iterations"] == 200 and detail["batch_size"] == 4096
  assert set(detail["atari_conv_mnih15"]) == {"capacity_65k_frames",
                                              "capacity_262k_frames"}
  for conv in detail["atari_conv_mnih15"].values():
    assert conv["batch_rows"] == 8 and conv["obs_shape"] == "20x20x4 uint8"
    assert conv["mfu"] is None and conv["power_limit"] is None
    assert conv["model_gflop_per_iteration"] * 1e9 == (
        bench_torch.conv_iteration_flops(20, 4, 6, 8, 16))
  host = detail["atari_host_replay_1m"]
  assert host["capacity_frames"] == 100_000 and host["pinned"] is False
  assert host["hashed_dedup_ratio"] == 97.0   # 99,328 frames, 1,024 unique
  assert all(host["checks"].values()) and len(host["checks"]) == 7
  sac = detail["sac_halfcheetah_live_throughput"]
  assert sac["ticks"] == 1200 and sac["ramp_runs"] == 1
  assert all(sac["checks"].values())


def test_smoke_keeps_widths_on_a_card():
  """On a card `--smoke` cuts chunks and runs only; the CPU's pixel smoke
  also takes `bench.py`'s smoke shapes. Each cut names the full value."""
  card = bench_torch.smoke_depths(torch.device("cuda"))
  assert card == bench_torch.SMOKE
  assert set(card["conv_bench"]) == {"chunk", "timed_chunks"}
  cpu = bench_torch.smoke_depths(torch.device("cpu"))
  assert cpu["conv_bench"] == {**bench_torch.SMOKE["conv_bench"],
                               **bench_torch.CONV_CPU_SMOKE}
  cuts = bench_torch.smoke_cuts(card)
  assert cuts[0] == ("bench_point: chunk 100 (full: 500), warmup_chunks 1 "
                     "(full: 8), timed_chunks 2 (full: 4)")
  assert "env_batch_size" not in cuts[1]
  assert "env_batch_size 8 (full: 128)" in bench_torch.smoke_cuts(cpu)[1]


def test_functions_run_with_tf32_off(monkeypatch):
  """Called directly, as through `main`, a function runs with TF32 off
  for matmul and cuDNN, and leaves the caller's setting as it was."""
  seen = []

  def stop(*args):
    seen.append((torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32))
    raise StopIteration

  monkeypatch.setattr(bench_torch, "warm_up", stop)
  monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
  with pytest.raises(StopIteration):
    bench_torch.bench_point("cpu")
  assert seen == [(False, False)]
  assert torch.backends.cuda.matmul.allow_tf32
  assert torch.backends.cudnn.allow_tf32


def test_chip_smoke_checks_of_the_line(smoke_output):
  """`chip_smoke.py`'s `bench` checks: all pass on the smoke's line with a
  card's fields, and each fails on a line broken its way."""
  line = json.loads(smoke_output)
  line["detail"]["card"] = {"name": "NVIDIA H100 80GB HBM3",
                            "power_limit": "700.00 W"}
  checks = chip_smoke.bench_line_checks(line, CARD)
  assert all(checks.values()), checks
  broken = {
      "keys": lambda l: l.update(error="x"),
      "detail_keys": lambda l: l["detail"].pop("tf32"),
      "numbers_finite": lambda l: l["detail"].update(wall_s=math.nan),
      "value_zero_iff_unsolved": lambda l: l.update(value=1.0),
      "card": lambda l: l["detail"]["card"].update(power_limit="400.00 W"),
      "tf32_off": lambda l: l["detail"]["tf32"].update(matmul=True),
      "smoke_cuts_listed": lambda l: l["detail"].update(reduced=[]),
  }
  for name, breaks in broken.items():
    bad = copy.deepcopy(line)
    breaks(bad)
    checks = chip_smoke.bench_line_checks(bad, CARD)
    assert not checks[name], name


@pytest.mark.parametrize("mujoco", [True, False])
def test_sac_live_probe_runs_on_the_cpu(monkeypatch, mujoco):
  """HalfCheetah-v5 through `suite_gym` where MuJoCo imports; the stand-in
  where it does not."""
  find_spec = importlib.util.find_spec
  if not mujoco:
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "mujoco"
                        else find_spec(name, *a))
  out = bench_torch.sac_live_probe(seconds=0.0, max_ramp_runs=1,
                                   device="cpu")
  if mujoco:
    assert out["env"] == "HalfCheetah-v5"
  else:
    assert out["env"].startswith("random_halfcheetah")
  assert out["ticks"] == bench_torch.SAC_MIN_TICKS and out["ramp_runs"] == 1
  assert all(out["checks"].values()), out["checks"]
  assert out["probe_ok"] == (out["utd_realized"] >= 0.8)
  for key in ("env_steps_per_s", "train_steps_per_s", "utd_realized",
              "ramp_utd", "window_s", "vs_baseline"):
    assert math.isfinite(out[key]) and out[key] >= 0, key
  assert out["env_steps_per_s"] > 0


@pytest.mark.parametrize("call", [
    lambda: bench_torch.main([]), bench_torch.bench_point,
    bench_torch.conv_bench, bench_torch.host_atari_replay_probe,
    bench_torch.sac_live_probe],
    ids=["main", "bench_point", "conv_bench", "host_atari_replay_probe",
         "sac_live_probe"])
def test_default_device_raises_without_a_card(monkeypatch, call):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    call()
