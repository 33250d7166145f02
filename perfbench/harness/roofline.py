"""Frozen: the peaks of one H100 SXM (NVIDIA's data sheet, dense rates) and
the least time of one kernel A launch (a copy of the program's
``chip_smoke.py::bound_ms`` at the time this benchmark was defined)."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores


def bound_ms(m: int, n: int, k: int, gs: int,
             f32: bool = False) -> tuple[float, str]:
    """x and out in bf16 (or f32), int8 codes, f32 scales and biases read
    once; operations at the dense bf16 rate (or the float32 one): the
    products, and the scale and bias applied the cheaper way, to each
    weight once (2nk) or to each row's group sums (2mgn)."""
    g = k // gs
    act = 4 if f32 else 2
    nbytes = m * k * act + n * k + 2 * g * n * 4 + m * n * act
    ops = 2 * m * n * k + 2 * n * min(k, m * g)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / (PEAK_F32_OPS_PER_S if f32 else PEAK_BF16_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
