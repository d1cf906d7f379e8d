# Hand-written CUDA kernels for Hopper (sm_90a): <name>/csrc/<name>.cu,
# its ctypes wrapper <name>/<name>.py, the plain PyTorch version
# <name>/ref.py and the device dispatch <name>/ops.py. _build.py compiles
# the sources with nvcc on first use.
