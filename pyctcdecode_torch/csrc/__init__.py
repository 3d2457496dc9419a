"""CUDA sources of the hand-written kernels and their nvcc + ctypes build."""
