"""Roofline accounting for the hot kernels.

This module supplies the card's published peaks, flop/byte models for the
factorization kernels, and a measured -> fraction-of-peak report used by
bench.py and the experiment scripts.

Peaks are per-card numbers from NVIDIA's H100 data sheet (dense rates,
without sparsity, at the full power limit); they bound the achievable rate,
they are not measured here.  A card set below its maximum power limit cannot
hold its top clock under a matrix-heavy load, so report the card's power
limit beside any share computed from these peaks.  f32 products run on the
CUDA cores at the FP32 rate when pinned to "highest" precision; at default
precision XLA may route them through the TF32 tensor cores.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    name: str
    f64_tflops: float        # FP64 tensor-core peak
    f32_tflops: float        # FP32 (CUDA cores; "highest" precision)
    tf32_tflops: float       # TF32 tensor-core peak, dense
    bf16_tflops: float       # bf16 tensor-core peak, dense
    hbm_gbps: float          # HBM bandwidth


# Keyed by jax Device.device_kind.  Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column (FP64 tensor 67, FP32 67, TF32 495 / bf16 989 dense,
# 3.35 TB/s HBM3).
_PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipPeaks(
        "NVIDIA H100 SXM", 67.0, 67.0, 495.0, 989.0, 3350.0),
}


def chip_peaks(device=None) -> ChipPeaks:
    """Peaks for the given (default: first) jax device; raises KeyError for
    a device kind not in the table (a roofline share against a guessed peak
    is not a measurement)."""
    if device is None:
        import jax

        device = jax.devices()[0]
    kind = getattr(device, "device_kind", str(device))
    try:
        return _PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(_PEAKS)}") from None


def dense_ldl_flops(n: int) -> float:
    """n^3/3 multiply-adds * 2 flops for an n x n LDL/Cholesky."""
    return 2.0 * n ** 3 / 3.0


def dense_ldl_bytes(n: int, dtype_bytes: int) -> float:
    """HBM traffic lower bound: read + write the n^2 triangle once each."""
    return 2.0 * n * n * dtype_bytes


def schedule_flops(bs) -> float:
    """Padded factorization flops of a supernodal schedule (the flops the
    device EXECUTES, including padding) — matches ops/sparse_chol.
    schedule_cost's flop term."""
    total = 0.0
    for it in bs.schedule:
        w, u = it.w_pad, it.u_pad
        fronts = it.count * getattr(it, "steps", 1)
        total += 2.0 * fronts * (w ** 3 / 3.0 + w * w * u + w * u * u)
    return total


def schedule_bytes(bs, dtype_bytes: int) -> float:
    """HBM traffic lower bound of a supernodal schedule: each bucketed
    front reads+writes its (w+u) x w panel and reads+writes its u x u
    extend-add update block once."""
    total = 0.0
    for it in bs.schedule:
        w, u = it.w_pad, it.u_pad
        fronts = it.count * getattr(it, "steps", 1)
        total += fronts * dtype_bytes * (2.0 * (w + u) * w + 2.0 * u * u)
    return total


_PEAK_FIELD = {"float64": "f64_tflops", "float32": "f32_tflops",
               "tf32": "tf32_tflops", "bfloat16": "bf16_tflops"}


def roofline_report(flops: float, bytes_moved: float, seconds: float,
                    dtype: str = "float32", device=None) -> dict:
    """Achieved GFLOP/s + GB/s and their fractions of the card's peaks.
    dtype selects the compute peak: float64, float32 (pinned "highest"),
    tf32 or bfloat16."""
    peaks = chip_peaks(device)
    peak_tf = getattr(peaks, _PEAK_FIELD[dtype])
    gflops = flops / seconds / 1e9
    gbps = bytes_moved / seconds / 1e9
    return {
        "chip": peaks.name,
        "seconds": seconds,
        "gflops": gflops,
        "flops_frac": gflops / (peak_tf * 1e3),
        "gbps": gbps,
        "hbm_frac": gbps / peaks.hbm_gbps,
    }
