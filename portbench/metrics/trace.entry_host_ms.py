"""`trace.entry_host_ms`: see `portbench.spanrun`."""
from portbench.spanrun import reader

read = reader("trace", "entry_host_ms")
