"""The sharded cases of `tests/test_weak_scaling.py` as collective-byte
bounds on the port's 2-rank gloo runs (the JAX tests read the compiled
program's collectives; the port's ranks count what they pass to
`torch.distributed`, `parallel.Mesh.largest_numel`).

- The fused DQN loop at the JAX test's size (B=64, ring 256, sample 32,
  (64,)): no collective carries as many elements as one rank's shard of
  one replay leaf (256 x 64 / 2): sampling is shard-local. Before
  `sample_sharded`, the JAX program all-gathered every storage leaf.
- PPO (B=64, T=16, (64, 64), 2 epochs x 4 minibatches, 8 shards, no
  metrics): only gradient-sized all-reduces and no all-gather at all: the
  minibatches are shard-local, so the rollout never crosses ranks.
The wall-clock case (`test_weak_scaling_program_overhead_bounded`) times
8 virtual devices on shared host cores; two processes sharing a card or
a CPU give no scaling figure, so it has no twin.
"""
import functools

import torch_dryrun as dryrun

RANKS, TIMEOUT_S = 2, 240
B, CAP, S = 64, 256, 32
PB, PT = 64, 16


def _param_numel(snapshot, prefixes):
  return sum(v.numel() for k, v in snapshot.items() if k.startswith(prefixes))


def test_sharded_iterations_pass_no_storage_or_rollout(tmp_path):
  jobs = [
      (functools.partial(dryrun.build_fused_loop, device="cpu", batch_size=B,
                         capacity=CAP, sample_batch_size=S, fc=(64,)),
       0, [100, 100], 3, 4),
      (functools.partial(dryrun.build_ppo_loop, device="cpu", batch_size=PB,
                         rollout_length=PT, num_epochs=2, num_minibatches=4,
                         num_minibatch_shards=8, fc=(64, 64),
                         metrics_buffer=None),
       0, [100, 100], 1, 0)]
  ranks = dryrun.spawn_ranks(dryrun.run_jobs, RANKS, (jobs,), str(tmp_path),
                             backend="gloo", device="cpu",
                             timeout_s=TIMEOUT_S)
  for dqn, ppo in ranks:
    shard = CAP * B // RANKS
    assert max(dqn["largest_numel"].values()) < shard, dqn["largest_numel"]
    assert dqn["largest_numel"]["all_reduce"] == _param_numel(
        dqn["snapshot"], ("agent.q_network.",))
    n_params = _param_numel(ppo["snapshot"], ("agent.actor_network.",
                                              "agent.value_network."))
    assert set(ppo["largest_numel"]) == {"all_reduce"}
    assert ppo["largest_numel"]["all_reduce"] == n_params
    assert all(b > 0 for b in dqn["bytes_per_iteration"]
               + ppo["bytes_per_iteration"])
