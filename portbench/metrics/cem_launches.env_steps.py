"""Device operations launched inside CEM's action optimizations
(`cem.optimize`) per `loop.iteration` entry, from the profiled stretch
(`portbench/spans.py`: each device operation is put down to the innermost
program span of its launch). None where the program opens no such
span."""
from portbench import spans


def read(run):
  return spans.launches_per_unit(run, "cem.optimize", "iterations")
