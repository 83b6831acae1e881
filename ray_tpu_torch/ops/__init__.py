"""Device ops of the port: ``flash_attention`` (CUDA kernel + plain version)."""
