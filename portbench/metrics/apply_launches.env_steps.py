"""Device operations (kernels, copies, sets) launched inside `agent.apply` per
train step, matched by their launch's correlation id in the profiled stretch
of fused DQN iterations with the program's spans recorded
(`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.launches_per_unit(run, "agent.apply", "train_steps")
