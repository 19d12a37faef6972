"""The port's kernels: CUDA C++ for Hopper under ``csrc/``, their ctypes
wrappers, their plain PyTorch versions (``ref``) and the device dispatch
(``ops``).  Nothing here builds or loads a kernel at import time."""
