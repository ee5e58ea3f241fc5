"""Host-side utilities: step timing and tracing (``profiling.py``)."""
