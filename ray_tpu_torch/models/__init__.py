"""Models of the port: ``gpt2`` (forward)."""
