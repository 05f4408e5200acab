"""Host-clock ms of R2D2's burn-in unrolls (`agent.burn_in`: the online
and the target network over the burn-in frames, without gradient) per
`loop.iteration` entry, from the recorded stretch of the program's own
spans (`portbench/spans.py`). None where the program opens no such
span."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "agent.burn_in", "iterations")
