"""Device halves of the port: PyTorch wrappers and their CUDA kernels."""
