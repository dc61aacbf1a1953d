"""Device stages of the block encode and their CUDA kernels."""
