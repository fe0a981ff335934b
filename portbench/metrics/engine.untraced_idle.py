"""`engine.untraced_idle`: see `portbench.spanrun`."""
from portbench.spanrun import reader

read = reader("fleet", "untraced_idle")
