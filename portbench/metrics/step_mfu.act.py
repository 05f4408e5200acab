"""Forward FLOPs of the window's act calls over its seconds, as a share of the
card's peak in the configuration's precision (%)."""
from portbench.reads import step_mfu_calls as read  # noqa: F401
