"""Device operations of the port: plain PyTorch versions and the wrappers
of the CUDA kernels."""
