"""Small-matrix algebra, angle wrapping and the CUDA kernel wrappers."""
