"""ms of one collect step of the loop alone, host clock over many calls to a
synchronize."""
from portbench.reads import collect_ms as read  # noqa: F401
