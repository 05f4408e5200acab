"""Host-clock ms of CEM's action optimizations (`cem.optimize`: the
collect step's and the TD target's) per `loop.iteration` entry, from the
recorded stretch of the program's own spans after the fused iterations'
timed window (`portbench/spans.py`). None where the program opens no
such span."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "cem.optimize", "iterations")
