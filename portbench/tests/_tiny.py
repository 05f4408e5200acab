"""Configuration fields that cut the training cells to a size the CPU runs
in seconds, for the tests only (the benchmark runs every width)."""

TINY = {
    "dqn_mnih15.fused_b128": {"env_batch_size": 8, "replay_capacity": 80,
                              "sample_batch_size": 64,
                              "initial_collect_steps": 8,
                              "target_update_period": 10},
    "sac_haarnoja18.fused_utd1": {"env_batch_size": 4, "replay_capacity": 80,
                                  "sample_batch_size": 16,
                                  "initial_collect_steps": 8,
                                  "train_steps_per_iteration": 4},
    "dqn_mnih15.act_b1": {},
}
SEED = 2**31 + 12345
