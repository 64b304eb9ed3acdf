"""Training of the port: for now only the evaluation loop (ROADMAP §A, item 6)."""
