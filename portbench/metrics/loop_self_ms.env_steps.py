"""Host-clock ms of the fused iteration's self time (`loop.iteration` less its
child spans) per `loop.iteration` entry, from the recorded stretch of the
program's own spans (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.self_ms(run, "loop.iteration", "iterations")
