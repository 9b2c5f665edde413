"""The arithmetic a reference runs in: ``float64`` for the reference itself,
``tf32`` for the control (float32 storage with every matrix product's
operands rounded to TF32's 10 explicit mantissa bits, the precision NVIDIA's
tensor cores give a float32 product when TF32 is switched on). The rounding
is emulated bit for bit, so the control reads the same on the CPU and the
card."""

import torch


class Arith:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def r(self, a):
        """Round to the precision's operand format."""
        if self.name == "float64":
            return a
        return tf32_round(a)

    def mm(self, a, b):
        """a @ b with both operands in the precision's operand format."""
        return self.r(a) @ self.r(b)


def tf32_round(a):
    """float32 -> the nearest value with 10 explicit mantissa bits (round
    half to even; inf and nan pass through)."""
    a = a.to(torch.float32).contiguous()
    i = a.view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(a)
    return torch.where(finite, r.view(torch.float32), a)
