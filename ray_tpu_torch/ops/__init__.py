"""Device ops of the port: ``flash_attention`` (CUDA kernels + plain
versions) and ``lm_head`` (the tied lm head's bf16 GEMMs into f32 logits,
with a Triton split of its cotangent + plain version)."""
