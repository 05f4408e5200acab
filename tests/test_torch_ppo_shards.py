"""PPO's `num_minibatch_shards` in one process against the JAX agent's
(``ppo_agent.py:96-103, 340-375``), which runs it without a mesh, so the
comparison is exact in its draws: each epoch key is split once per shard
and each shard's items permuted on their own
(``permutation(split(epoch_key, n_sh)[s], per)``), replayed into the port
at site "ppo_permutation" in shard order; every minibatch takes an equal
slice of every shard. From a converted JAX state after one JAX step, the
second step's losses, extras, networks, Adam moments (second moments to
atol 1e-9), normalizers and beta agree at rtol 1e-5 / atol 1e-6; and a
shard count that does not split the items raises as in JAX."""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close
from test_torch_ppo_agent import (ATOL, B, RTOL, SCHEDULE_STEPS, T, VARIANTS,
                                  _jax_nets, _specs, _torch_nets,
                                  assert_ppo_states_close, experience,
                                  to_jax, to_torch)

torch.set_num_threads(1)

EPOCHS, MINIBATCHES = 2, 2


def sharded_agents(variant, shards):
  discrete, jcls, tcls, kwargs, schedule = VARIANTS[variant]
  kwargs = dict(num_epochs=EPOCHS, num_minibatches=MINIBATCHES,
                num_minibatch_shards=shards, **kwargs)
  lr = (optax.linear_schedule(3e-3, 0.0, SCHEDULE_STEPS) if schedule
        else 3e-3)
  obs, act = _specs(jspec, discrete)
  jagent = jcls(jts.time_step_spec(obs), act, optax.adam(lr, eps=1e-5),
                *_jax_nets(discrete), **kwargs)
  tobs, tact = _specs(tspec, discrete)
  lr_schedule = ((lambda c: 1.0 - min(c, SCHEDULE_STEPS) / SCHEDULE_STEPS)
                 if schedule else None)
  tagent = tcls(tts.time_step_spec(tobs), tact,
                lambda p: torch.optim.Adam(p, lr=3e-3, eps=1e-5),
                *_torch_nets(discrete), lr_schedule=lr_schedule,
                device="cpu", **kwargs)
  return jagent, tagent


def jax_shard_permutations(key, num_epochs, shards, per):
  """`PPOAgent.train`'s shard-local shuffles: per epoch key, one
  permutation of `per` items per ``split(epoch_key, shards)`` key."""
  return {"ppo_permutation": [
      np.asarray(jax.random.permutation(k, per))
      for ek in jax.random.split(key, num_epochs)
      for k in jax.random.split(ek, shards)]}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_train_matches_jax(variant, shards):
  jagent, tagent = sharded_agents(variant, shards)
  discrete = VARIANTS[variant][0]
  jtrain = jax.jit(jagent.train)
  e1, e2 = experience(0, discrete), experience(1, discrete)
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), to_jax(e1),
                     key=jax.random.key(1))
  tstate = convert.load_ppo_agent_state(
      tagent.init(), convert.ppo_agent_state_to_torch(jax.device_get(jstate)))
  k2 = jax.random.key(2)
  jstate2, jinfo = jtrain(jstate, to_jax(e2), key=k2)
  draws = ReplayDraws(jax_shard_permutations(k2, EPOCHS, shards,
                                             B * (T - 1) // shards))
  tstate2, tinfo = tagent.train(tstate, to_torch(e2), draws=draws)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, "loss")
  for f in dataclasses.fields(tinfo.extra):
    assert_close(getattr(tinfo.extra, f.name), getattr(jinfo.extra, f.name),
                 RTOL, ATOL, f.name)
  assert_ppo_states_close(jstate2, tstate2, "trained")


@pytest.mark.parametrize("shards", [3, 8])
def test_shards_that_do_not_split_raise_like_jax(shards):
  """32 frames over 3 shards, or 8 shards of the 4 rows: both raise."""
  jagent, tagent = sharded_agents("plain", shards)
  e = experience(0, True)
  with pytest.raises(ValueError, match="num_minibatch_shards"):
    jagent.train(jagent.init(jax.random.key(0)), to_jax(e),
                 key=jax.random.key(1))
  with pytest.raises(ValueError, match="num_minibatch_shards"):
    tagent.train(tagent.init(), to_torch(e))
