"""One reader a per-layer metric, ``<name>.py`` with ``read(trace)``."""
