"""Candidate actions CEM scored (`cem.candidates`, the final answers'
included) per image it ran through a critic's torso (`cem.torso_images`),
in the recorded stretch after the fused iterations' timed window
(`portbench/spans.py`): iterations x samples + 1 where the critic's torso
runs once a row, 1 where every candidate is tiled with its image. None
where the program keeps no such counters."""
from portbench import spans


def read(run):
  got = spans.stretches(run)
  if got is None:
    return None
  counters = got["recorded"]["summary"]["counters"]
  candidates, images = (counters.get("cem.candidates"),
                        counters.get("cem.torso_images"))
  if candidates is None or not images:
    return None
  return candidates / images
