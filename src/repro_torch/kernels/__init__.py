# Hand-written CUDA kernels for Hopper (sm_90a): <name>/csrc/<name>.cu,
# its ctypes wrapper <name>/<name>.py, the plain PyTorch version
# <name>/ref.py and the device dispatch <name>/ops.py. _build.py compiles
# the sources with nvcc on first use.


def on_card(t) -> bool:
    """True where tensor ``t`` lies on a CUDA device. The models' kernel
    entry points (``flash_gqa/ops.py``, ``ssd_scan/ops.py``,
    ``partition_pack/ops.py`` and ``models/transformer.py:_attend``) ask
    this one question and send such tensors to the hand-written kernels,
    others to the plain versions."""
    return t.device.type == "cuda"
