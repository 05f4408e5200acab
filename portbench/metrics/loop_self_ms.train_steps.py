"""Host-clock ms of the fused iteration's self time (`loop.iteration` less its
child spans) per train step (the `agent.train_steps` counter), from the
recorded stretch of the program's own spans (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.self_ms(run, "loop.iteration", "train_steps")
