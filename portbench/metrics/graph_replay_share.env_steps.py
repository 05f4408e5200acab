"""% of the train steps that replayed the DQN train step's CUDA graph: the
program's `agent.graph_replays` counter over its `agent.train_steps`, in
the recorded stretch after the fused DQN iterations' timed window
(`portbench/spans.py`). None where the program keeps no such counter."""
from portbench import spans


def read(run):
  got = spans.stretches(run)
  if got is None:
    return None
  counters = got["recorded"]["summary"]["counters"]
  replays, steps = (counters.get("agent.graph_replays"),
                    counters.get("agent.train_steps"))
  if replays is None or not steps:
    return None
  return 100.0 * replays / steps
