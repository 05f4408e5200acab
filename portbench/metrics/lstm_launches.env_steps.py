"""Device operations launched inside the LSTM's spans (`lstm.unroll`,
`lstm.backward`) per `loop.iteration` entry, from the profiled stretch
(`portbench/spans.py`: each device operation is put down to the innermost
program span of its launch). None where the program opens neither
span."""
from portbench import lstm, spans


def read(run):
  got = [spans.launches_per_unit(run, name, "iterations")
         for name in lstm.SPANS]
  got = [n for n in got if n is not None]
  return sum(got) if got else None
