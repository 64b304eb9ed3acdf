"""Host-side utilities of the port: metric accumulators and experiment files."""
