"""Share of the timed window of act calls in which the card ran no operation
(%): the profiled sub-window's device busy time per unit, over the timed
window's pace."""
from portbench.reads import idle_share as read  # noqa: F401
