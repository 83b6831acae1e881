"""Host-side pieces of the runtime that the ported modules need: the flag
registry and the exception types."""
