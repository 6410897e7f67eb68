"""glue_device_ms (limb engine): device ms a call in kernels that are not
the program's own CUDA kernels (the ``__global__`` functions of its
``csrc/*.cu``, read from its sources) and not NCCL's: the PyTorch glue."""

from portbench.trace import name_matcher


def read(r):
    if r.trace is None:
        return None
    own = [name_matcher(k) for k in r.port_kernels]
    return r.trace.device_ms_per_call(
        lambda name: not name.startswith("nccl") and not any(m(name) for m in own))
