"""The comparisons that decide ``correct``, one module an entry kind."""
