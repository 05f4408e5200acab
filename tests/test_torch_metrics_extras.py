"""The port's `MaxReturnMetric`, `MinReturnMetric`,
`AverageReturnMultiMetric`, `ChosenActionHistogram`, `MetricsGroup`,
`evaluate_torch_env` and `export_utils.export_metrics` against the JAX
package, on the same numpy-made frames (as
``tests/test_driver_metrics.py:106,152`` and
``tests/test_metric_equality.py`` hold the JAX ones). Floats agree to rtol
1e-5 / atol 1e-6, counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.eval import metric_utils as jmetric_utils
from agents_tpu.metrics import export_utils as jexport_utils
from agents_tpu.metrics import jax_metrics
from agents_tpu.metrics import py_metrics as jpy_metrics
from agents_tpu.policies.q_policy import QPolicy as JaxQPolicy
from agents_tpu.policies.wrappers import GreedyPolicy as JaxGreedyPolicy
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.eval import metric_utils
from agents_tpu_torch.metrics import export_utils, py_metrics, torch_metrics
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.policies import GreedyPolicy, QPolicy
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_reset_draws)

torch.set_num_threads(1)


def _frames(seed, b=3, t=24, reward_len=None, num_actions=4):
  """Numpy frames of `b` rows over `t` steps: random episode ends,
  boundary frames after each LAST, random rewards and actions."""
  rng = np.random.RandomState(seed)
  st = np.zeros((t, b), np.int32)
  for row in range(b):
    s = 0
    for k in range(t):
      st[k, row] = s
      s = {0: 1, 1: 2 if rng.rand() < 0.3 else 1, 2: 0}[s]
  nst = np.roll(st, -1, axis=0)
  nst[-1] = np.where(st[-1] == 2, 0, np.where(st[-1] == 0, 1, 2))
  shape = (t, b) if reward_len is None else (t, b, reward_len)
  reward = rng.uniform(-1, 1, shape).astype(np.float32)
  action = rng.randint(0, num_actions, (t, b)).astype(np.int32)
  frames = []
  for k in range(t):
    frames.append(dict(step_type=st[k], observation=np.zeros((b, 1),
                                                             np.float32),
                       action=action[k], policy_info=(),
                       next_step_type=nst[k], reward=reward[k],
                       discount=np.ones((b,), np.float32)))
  return frames


def _run_both(jmetric, tmetric, frames, b=3):
  js, ts_ = jmetric.init(b), tmetric.init(b, "cpu")
  for f in frames:
    js = jmetric.update(js, jtj.Trajectory(
        **{k: jnp.asarray(v) if k != "policy_info" else () for k, v in
           f.items()}))
    ts_ = tmetric.update(ts_, tj.Trajectory(
        **{k: torch.as_tensor(v) if k != "policy_info" else () for k, v in
           f.items()}))
  return np.asarray(jmetric.result(js)), tmetric.result(ts_)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["MaxReturnMetric", "MinReturnMetric"])
def test_max_and_min_return_match_jax(name, seed):
  frames = _frames(seed)
  want, got = _run_both(getattr(jax_metrics, name)(4),
                        getattr(torch_metrics, name)(4), frames)
  assert_close(got, want)
  assert got.shape == ()


def test_max_and_min_of_an_empty_deque_are_zero():
  for name in ("MaxReturnMetric", "MinReturnMetric"):
    m = getattr(torch_metrics, name)(3)
    assert float(m.result(m.init(2, "cpu"))) == 0.0


@pytest.mark.parametrize("seed", [0, 3])
def test_average_return_multi_matches_jax(seed):
  frames = _frames(seed, reward_len=2)
  want, got = _run_both(jax_metrics.AverageReturnMultiMetric(2, 4),
                        torch_metrics.AverageReturnMultiMetric(2, 4), frames)
  assert got.shape == (2,)
  assert_close(got, want)


def test_average_return_multi_twin_of_the_jax_case():
  """``tests/test_driver_metrics.py``'s two-step episodes per row."""
  m = torch_metrics.AverageReturnMultiMetric(reward_len=2, buffer_size=4)
  state = m.init(2, "cpu")

  def frame(reward, next_step_type):
    return tj.Trajectory(
        step_type=torch.ones(2, dtype=torch.int32),
        observation=torch.zeros(2, 1), action=torch.zeros(2, dtype=torch.int32),
        policy_info=(), next_step_type=torch.tensor(next_step_type,
                                                     dtype=torch.int32),
        reward=torch.tensor(reward), discount=torch.ones(2))

  state = m.update(state, frame([[1., 10.], [3., 5.]], [1, 1]))
  state = m.update(state, frame([[2., 20.], [4., 6.]], [2, 2]))
  np.testing.assert_allclose(m.result(state).numpy(),
                             [(3. + 7.) / 2, (30. + 11.) / 2])


@pytest.mark.parametrize("seed", [0, 4])
def test_chosen_action_histogram_matches_jax(seed):
  frames = _frames(seed, num_actions=4)
  want, got = _run_both(jax_metrics.ChosenActionHistogram(4),
                        torch_metrics.ChosenActionHistogram(4), frames)
  assert_equal(got, want)
  assert torch_metrics.ChosenActionHistogram.result_kind == "counts"
  # Boundary frames are not counted.
  assert int(got.sum()) < 3 * 24


def test_metrics_group_state_roundtrip_matches_jax():
  def frame(mod, reward, next_step_type):
    return mod.Trajectory(
        step_type=np.ones((2,), np.int32), observation=np.zeros((2, 1)),
        action=np.zeros((2,), np.int32), policy_info=(),
        next_step_type=np.asarray(next_step_type, np.int32),
        reward=np.asarray(reward, np.float32),
        discount=np.ones((2,), np.float32))

  results = []
  for mod, pm, group in ((tj, py_metrics, metric_utils.MetricsGroup),
                         (jtj, jpy_metrics, jmetric_utils.MetricsGroup)):
    g = group([pm.AverageReturnMetric(5), pm.EnvironmentSteps()])
    for m in g.metrics:
      m(frame(mod, [1.0, 2.0], [2, 2]))
    snap = g.state_dict()
    g2 = group([pm.AverageReturnMetric(5), pm.EnvironmentSteps()])
    g2.load_state_dict(snap)
    assert g2.results() == g.results()
    g2.reset()
    assert g2.results()["EnvironmentSteps"] == 0
    results.append((g.results(), snap))
  (port, port_snap), (jax_res, jax_snap) = results
  assert {k: float(v) for k, v in port.items()} == {
      k: float(v) for k, v in jax_res.items()}
  assert port["AverageReturn"] == 1.5
  assert set(port_snap) == set(jax_snap)


def test_export_metrics_matches_jax():
  class Writer:
    def __init__(self):
      self.rows = []

    def scalar(self, name, value, step):
      self.rows.append((name, value, step))

  out = []
  for mod, exp in ((py_metrics, export_utils), (jpy_metrics, jexport_utils)):
    m = mod.EnvironmentSteps()
    m(tj.Trajectory(step_type=np.ones((3,), np.int32),
                    observation=np.zeros((3, 1)),
                    action=np.zeros((3,), np.int32), policy_info=(),
                    next_step_type=np.ones((3,), np.int32),
                    reward=np.zeros((3,), np.float32),
                    discount=np.ones((3,), np.float32)))
    w = Writer()
    out.append((exp.export_metrics(12, [m], w, prefix="eval"), w.rows))
  assert out[0] == out[1] == ({"eval/EnvironmentSteps": 3.0},
                              [("eval/EnvironmentSteps", 3.0, 12)])


@pytest.mark.parametrize("num_steps", [20, 45])
def test_evaluate_torch_env_matches_evaluate_jax_env(num_steps):
  """A greedy Q policy over a fixed number of lockstep steps on 6
  CartPoles, from the same params and the JAX run's env draws."""
  b = 6
  jenv = BatchedJaxEnv(JaxCartPole(max_episode_steps=15), batch_size=b)
  tss, asp = jenv.time_step_spec(), jenv.action_spec()
  jnet = jnetworks.make_q_network(tss.observation, asp, fc_layer_params=(8,))
  params = jnet.init_params(jax.random.key(2))
  key = jax.random.key(5)
  jout = jmetric_utils.evaluate_jax_env(
      jenv, JaxGreedyPolicy(JaxQPolicy(tss, asp, jnet)), params, key,
      num_steps)

  env = BatchedTorchEnv(CartPole(max_episode_steps=15), b, device="cpu")
  ttss, tasp = env.time_step_spec(), env.action_spec()
  net = make_q_network(ttss.observation, tasp, fc_layer_params=(8,),
                       device="cpu")
  net.load_state_dict(convert.q_params_to_state_dict(params))
  k_init, k_run = jax.random.split(key)
  run = jax_collect_draws(k_run, num_steps, b, asp,
                          policy=lambda k, n, spec: {})
  draws = ReplayDraws({"env_reset": [jax_reset_draws(k_init, b)]
                       + run["env_reset"]})
  out = metric_utils.evaluate_torch_env(
      env, GreedyPolicy(QPolicy(ttss, tasp, net)), net, draws, num_steps)
  assert set(out) == set(jout)
  for k in out:
    assert_close(out[k], jout[k], err_msg=k)
  assert int(out["NumberOfEpisodes"]) > 0
