"""Kernel layer: backend dispatch, the nvcc/ctypes build, and the
hand-written Hopper kernels (serving: fixed-point matmul, paged attention;
training: the fused SYMOG update) with their plain versions."""
