"""Build and load of the CUDA kernels in ``ray_tpu_torch/csrc``."""
