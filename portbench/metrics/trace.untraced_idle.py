"""`trace.untraced_idle`: see `portbench.spanrun`."""
from portbench.spanrun import reader

read = reader("trace", "untraced_idle")
