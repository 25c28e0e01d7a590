"""Image and descriptor ops, and the wrappers of the CUDA kernels."""
