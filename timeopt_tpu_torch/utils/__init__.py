"""Host-side utilities of the port: the phase timers (timing.py) and the tracing (trace.py)."""
