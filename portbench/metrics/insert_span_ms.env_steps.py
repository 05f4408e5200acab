"""Host-clock ms of the observers' fold of each collected frame
(`replay.insert`: the replay's insert and the metrics' updates) per
`loop.iteration` entry, from the recorded stretch of the program's own spans
after the fused DQN iterations' timed window (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "replay.insert", "iterations")
