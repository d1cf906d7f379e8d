# Hand-written CUDA kernels for Hopper (sm_90a): <name>/csrc/<name>.cu,
# its ctypes wrapper <name>/<name>.py, the plain PyTorch version
# <name>/ref.py and the device dispatch <name>/ops.py. _build.py compiles
# the sources with nvcc on first use.
import contextlib

# the step analyses listening to the kernel entries
# (launch/step_analysis.py); each is told of every entry's call
listeners: list = []


def on_card(t) -> bool:
    """True where tensor ``t`` lies on a CUDA device. The models' kernel
    entry points (``flash_gqa/ops.py``, ``ssd_scan/ops.py``,
    ``partition_pack/ops.py``, ``moe_combine/ops.py`` and
    ``models/transformer.py:_attend``) ask
    this one question (through ``kernel_route``) and send such tensors to
    the hand-written kernels, others to the plain versions."""
    return t.device.type == "cuda"


def kernel_route(t) -> bool:
    """True where a call on ``t`` takes a kernel's route: on the card, and
    on the meta device, which stands in for it in the dry run (a wrapper's
    launch there is shape-only: it allocates the kernel's outputs and
    computes nothing; gradients run the plain version, as on the card)."""
    return on_card(t) or t.device.type == "meta"


@contextlib.contextmanager
def entry(name: str, work):
    """One call of kernel ``name`` through its entry point; ``work()`` ->
    (flops, bytes) of the function at this call's shapes (its ``work``).
    Each listening analysis counts the call as one row and none of the
    operations inside it, though it sees what they allocate."""
    if not listeners:
        yield
        return
    flops, nbytes = work()
    for a in listeners:
        a.enter_kernel(name, flops, nbytes)
    try:
        yield
    finally:
        for a in listeners:
            a.exit_kernel()


def strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for d in reversed(shape):
        out.insert(0, acc)
        acc *= d
    return tuple(out)


def from_local(t, mesh, placements, shape):
    """``t``, this rank's shard of a contiguous tensor of global ``shape``
    laid out by ``placements`` on ``mesh``, as a DTensor (abstract
    parameters, and the kernel entries' outputs on a mesh)."""
    import torch
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=strides(shape))
