"""% of the act calls that replayed the exported program's CUDA graph: the
loader's `act.replay` entries over its `act.call` entries, in the recorded
stretch after the act calls' timed window (`portbench/spans.py`). None
where the loader opens no such span."""
from portbench import spans


def read(run):
  got = spans.stretches(run)
  if got is None:
    return None
  recorded = got["recorded"]["summary"]["spans"]
  replays, calls = recorded.get("act.replay"), recorded.get("act.call")
  if replays is None or not calls or not calls["calls"]:
    return None
  return 100.0 * replays["calls"] / calls["calls"]
