"""`engine.entry_host_ms`: see `portbench.spanrun`."""
from portbench.spanrun import reader

read = reader("fleet", "entry_host_ms")
