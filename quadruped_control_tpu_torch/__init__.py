"""quadruped_control_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port.

Beside ``quadruped_control_tpu`` (JAX + Pallas, the reference). Same
sub-package names so a reader finds the counterpart; the TPU kernels become
hand-written CUDA C++ kernels under ``csrc/`` (built at first use by
``kernels.py``). The package imports ``torch`` and ``numpy`` only.

Float32 products run in full float32: TF32 is pinned off at import (the twin
of the reference's ``jax_default_matmul_precision=highest``) — the polish
certificate sits a few ulps above machine epsilon and does not survive a
10-bit mantissa anywhere upstream of it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means ``cuda``: the port
    runs on the card unless the caller asks for the CPU, and a missing card
    raises instead of carrying on elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "quadruped_control_tpu_torch: device 'cuda' requested (the "
            "default) but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path on the host")
    return dev
