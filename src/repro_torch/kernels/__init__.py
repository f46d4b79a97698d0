"""Kernel layer: backend dispatch, the nvcc/ctypes build, and the two
hand-written Hopper kernels of the serving path with their plain versions."""
