"""Models of the port: ``gpt2`` (with its MoE), ``llama`` and the
``mnist`` CNN."""
