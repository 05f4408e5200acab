"""Port parity: `BehavioralCloningAgent` (`agents_tpu_torch.agents.
behavioral_cloning`) against the JAX package's, in both branches: the
negative log-likelihood of a SAC (tanh-squashed Gaussian) actor on a
continuous spec, and the cross-entropy of a Q network's logits with the
integer actions as labels.

The train steps start from a whole JAX `BcAgentState` carried across by
`convert.bc_agent_state_to_torch` and take ``[B, T] = [8, 3]`` experience,
flattened to 24 frames on both sides; losses, the network and the Adam
moments and count agree to rtol 1e-5 / atol 1e-6 (the second moments to
atol 1e-9) in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.agents.behavioral_cloning import \
    BehavioralCloningAgent as JaxBcAgent
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.agents.behavioral_cloning import BehavioralCloningAgent
from agents_tpu_torch.networks import make_q_network, make_sac_actor_network
from agents_tpu_torch.policies import (ActorPolicy, EpsilonGreedyPolicy,
                                       GreedyPolicy)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)

RTOL, ATOL, NU_ATOL = 1e-5, 1e-6, 1e-9
B, T = 8, 3


def _specs(module, kind, minimum=0):
  if kind == "distribution":
    return (module.BoundedArraySpec((3,), np.float32, -8.0, 8.0),
            module.BoundedArraySpec((1,), np.float32, -2.0, 2.0))
  return (module.BoundedArraySpec((4,), np.float32, -5.0, 5.0),
          module.BoundedArraySpec((), np.int32, minimum, minimum + 2))


def _agents(kind, **kwargs):
  jobs, jact = _specs(jspec, kind)
  tobs, tact = _specs(tspec, kind)
  if kind == "distribution":
    jnet = jnetworks.make_sac_actor_network(jobs, jact, fc_layer_params=(16,))
    tnet = make_sac_actor_network(tobs, tact, (16,), device="cpu")
  else:
    jnet = jnetworks.make_q_network(jobs, jact, fc_layer_params=(16,))
    tnet = make_q_network(tobs, tact, fc_layer_params=(16,), device="cpu")
  is_dist = kind == "distribution"
  jagent = JaxBcAgent(jts.time_step_spec(jobs), jact, jnet, optax.adam(1e-3),
                      network_is_distribution=is_dist, **kwargs)
  tagent = BehavioralCloningAgent(
      tts.time_step_spec(tobs), tact, tnet,
      lambda p: torch.optim.Adam(p, lr=1e-3), network_is_distribution=is_dist,
      device="cpu", **kwargs)
  return jagent, tagent


def _experience(kind, seed):
  rng = np.random.RandomState(seed)
  obs_dim = 3 if kind == "distribution" else 4
  if kind == "distribution":
    action = rng.uniform(-1.95, 1.95, (B, T, 1)).astype(np.float32)
  else:
    action = rng.randint(0, 3, (B, T)).astype(np.int32)
  return dict(
      step_type=rng.choice([0, 1, 2], size=(B, T)).astype(np.int32),
      observation=(rng.randn(B, T, obs_dim) * 2).astype(np.float32),
      action=action,
      next_step_type=rng.choice([0, 1, 2], size=(B, T)).astype(np.int32),
      reward=rng.randn(B, T).astype(np.float32),
      discount=np.ones((B, T), np.float32))


def _sd(kind):
  return (convert.sac_actor_params_to_state_dict if kind == "distribution"
          else convert.q_params_to_state_dict)


def assert_bc_states_close(kind, jstate, tstate, msg):
  expect = convert.bc_agent_state_to_torch(jax.device_get(jstate), _sd(kind))
  for k, v in tstate.network.state_dict().items():
    assert_close(v, expect["network"][k], RTOL, ATOL, f"{msg} {k}")
  params = [p for g in tstate.optimizer.param_groups for p in g["params"]]
  for i, p in enumerate(params):
    st, ex = tstate.optimizer.state[p], expect["adam"][i]
    assert float(st["step"]) == float(ex["step"]), f"{msg} step"
    assert_close(st["exp_avg"], ex["exp_avg"], RTOL, ATOL, f"{msg} mu {i}")
    assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], RTOL, NU_ATOL,
                 f"{msg} nu {i}")
  assert tstate.train_step == expect["train_step"]


@pytest.mark.parametrize("kind,clip", [("distribution", None),
                                       ("distribution", 0.5),
                                       ("logits", None)])
def test_train_steps_match_jax_on_b_t_experience(kind, clip):
  jagent, tagent = _agents(kind, gradient_clipping=clip)
  jtrain = jax.jit(jagent.train)
  exps = [_experience(kind, seed) for seed in range(4)]
  to_jax = lambda e: jtj.Trajectory(  # noqa: E731
      policy_info=(), **{k: jnp.asarray(v) for k, v in e.items()})
  to_torch = lambda e: ttj.Trajectory(  # noqa: E731
      policy_info=(), **{k: torch.from_numpy(v) for k, v in e.items()})
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), to_jax(exps[0]))
  tstate = convert.load_bc_agent_state(
      tagent.init(), convert.bc_agent_state_to_torch(jax.device_get(jstate),
                                                     _sd(kind)))
  assert_bc_states_close(kind, jstate, tstate, "converted")
  for step, e in enumerate(exps[1:], start=2):
    jstate, jinfo = jtrain(jstate, to_jax(e))
    tstate, tinfo = tagent.train(tstate, to_torch(e))
    assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, f"step {step} loss")
    assert_bc_states_close(kind, jstate, tstate, f"step {step}")
  assert tstate.train_step == 4


def test_policies_and_the_spec_minimum_raise():
  _, tagent = _agents("distribution")
  assert isinstance(tagent.collect_policy, ActorPolicy)
  assert isinstance(tagent.policy, GreedyPolicy)
  assert tagent.train_sequence_length is None
  _, qagent = _agents("logits")
  assert isinstance(qagent.collect_policy, EpsilonGreedyPolicy)
  assert qagent.collect_policy.epsilon == 0.1
  for module, build in ((jspec, lambda obs, act: JaxBcAgent(
      jts.time_step_spec(obs), act,
      jnetworks.make_q_network(obs, act, fc_layer_params=(8,)),
      optax.adam(1e-3), network_is_distribution=False)),
                        (tspec, lambda obs, act: BehavioralCloningAgent(
                            tts.time_step_spec(obs), act,
                            make_q_network(obs, _specs(tspec, "logits")[1],
                                           fc_layer_params=(8,),
                                           device="cpu"),
                            torch.optim.Adam, network_is_distribution=False,
                            device="cpu"))):
    obs, act = _specs(module, "logits", minimum=1)
    with pytest.raises(ValueError, match="minimum 0"):
      build(obs, act)
