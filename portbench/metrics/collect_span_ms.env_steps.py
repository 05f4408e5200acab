"""Host-clock ms of the loop's collect (`loop.collect`: the policy, the env
step and the replay insert) per `loop.iteration` entry, from the recorded
stretch of the program's own spans after the fused DQN iterations' timed
window (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "loop.collect", "iterations")
