"""`RandomPolicy`, `RandomAgent` and `FixedPolicyAgent` of the port against
the JAX package's: actions inside every spec, the uniform log-probability
equal to the JAX policy's, and the trivial agents' counting train step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.agents.random import RandomAgent as JaxRandomAgent
from agents_tpu.policies.random_policy import RandomPolicy as JaxRandomPolicy
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.agents.random import FixedPolicyAgent, RandomAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import Pendulum
from agents_tpu_torch.policies import RandomPolicy
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.train import FusedTrainLoop
from agents_tpu_torch.trajectories import policy_step as tps
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils.draws import Draws
from test_torch_parity_utils import assert_close

B = 512


def _action_spec(module):
  return {"force": module.BoundedArraySpec((3,), np.float32, -2.0, 2.0),
          "gear": module.BoundedArraySpec((2,), np.int32, 1, 4),
          "brake": module.ArraySpec((), np.bool_),
          "skew": module.BoundedArraySpec(
              (2,), np.float32, np.array([-1.0, 0.0], np.float32),
              np.array([1.0, 5.0], np.float32))}


def test_random_policy_within_spec_with_the_jax_log_probability():
  obs = np.zeros((B, 3), np.float32)
  tact = _action_spec(tspec)
  tpol = RandomPolicy(tts.time_step_spec(tspec.ArraySpec((3,), np.float32)),
                      tact, emit_log_probability=True)
  step = tts.TimeStep(step_type=torch.zeros(B, dtype=torch.int32),
                      reward=torch.zeros(B), discount=torch.ones(B),
                      observation=torch.from_numpy(obs))
  out = tpol.action((), step, (), Draws(0, "cpu"))
  a = out.action
  assert bool(((a["force"] >= -2.0) & (a["force"] < 2.0)).all())
  assert a["gear"].dtype == torch.int32
  assert set(a["gear"].unique().tolist()) == {1, 2, 3, 4}
  assert a["brake"].dtype == torch.bool and 0 < int(a["brake"].sum()) < B
  assert bool(((a["skew"][:, 0] >= -1.0) & (a["skew"][:, 0] < 1.0)).all())
  assert bool(((a["skew"][:, 1] >= 0.0) & (a["skew"][:, 1] < 5.0)).all())
  assert tspec.BoundedArraySpec((3,), np.float32, -2.0, 2.0).check_array(
      a["force"][0])

  jpol = JaxRandomPolicy(jts.time_step_spec(jspec.ArraySpec((3,),
                                                            np.float32)),
                         _action_spec(jspec), emit_log_probability=True)
  jstep = jts.TimeStep(step_type=jnp.zeros(B, jnp.int32),
                       reward=jnp.zeros(B), discount=jnp.ones(B),
                       observation=jnp.asarray(obs))
  jout = jpol.action((), jstep, (), jax.random.key(0))
  expected = jps.get_log_probability(jout.info)
  got = tps.get_log_probability(out.info)
  assert tuple(got.shape) == (B,)
  assert_close(got, expected, 1e-6, 1e-6)
  # 3 log 4 + 2 log 4 + log 2 + log 2 + log 5 (the skew leaf's ranges).
  assert float(got[0]) == pytest.approx(
      -(3 * np.log(4) + 2 * np.log(4) + np.log(2) + np.log(2) + np.log(5)),
      rel=1e-6)
  with pytest.raises(NotImplementedError):
    tpol.distribution((), step)


def test_random_and_fixed_policy_agents_count_their_steps():
  env = Pendulum()
  tss = tts.time_step_spec(env.observation_spec())
  agent = RandomAgent(tss, env.action_spec(), device="cpu")
  jagent = JaxRandomAgent(jts.time_step_spec(jspec.ArraySpec((3,),
                                                             np.float32)),
                          jspec.BoundedArraySpec((1,), np.float32, -2., 2.))
  state = agent.init()
  assert agent.policy_params(state) == () == jagent.policy_params(
      jagent.init(jax.random.key(0)))
  assert agent.train_sequence_length is None
  for _ in range(3):
    state, info = agent.train(state, None)
  assert state.train_step == 3 and float(info.loss) == 0.0
  fixed = FixedPolicyAgent(tss, env.action_spec(), agent.policy,
                           device="cpu")
  assert fixed.collect_policy is agent.policy
  assert fixed.train(fixed.init(), None)[0].train_step == 1


def test_random_agent_fills_a_ring_in_the_fused_loop():
  """The random agent drives the fused loop as any agent does: the ring
  fills with in-spec Pendulum actions and every iteration trains (counts)
  once."""
  env = BatchedTorchEnv(Pendulum(), 4, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = RandomAgent(tss, asp, device="cpu")
  replay = UniformReplay(ttj.trajectory_spec(tss, asp), 4, 32, device="cpu")
  loop = FusedTrainLoop(env, agent, replay, sample_batch_size=8,
                        device="cpu")
  state = loop.init(seed=0, initial_collect_steps=20)
  state, losses = loop.run(state, 5)
  assert state.replay_state.count == 25 and state.agent_state.train_step == 5
  assert bool((losses == 0).all())
  actions = state.replay_state.storage.action[:25]
  assert bool(((actions >= -2.0) & (actions <= 2.0)).all())
  assert float(actions.std()) > 0.5
