"""Published peak rates of the devices this program is measured on.

Keyed by `jax.Device.device_kind`. A device that is not in the table is an
error: no rate is ever guessed. Source: NVIDIA's H100 data sheet, SXM part,
dense rates without sparsity, at the full 700 W power limit. A card set to
a lower limit (`nvidia-smi --query-gpu=power.limit`) cannot hold its top
clock under load, so every measurement prints that limit beside it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    fp32_flops: float  # CUDA cores, no tensor cores
    tf32_flops: float  # tensor cores
    bf16_flops: float  # tensor cores
    hbm_bytes_per_s: float
    link_bytes_per_s: float  # NVLink to the host's other cards, each way


H100_SXM = DevicePeaks(
    fp32_flops=67e12,
    tf32_flops=495e12,
    bf16_flops=989e12,
    hbm_bytes_per_s=3.35e12,
    link_bytes_per_s=450e9,
)

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks_for(device_kind: str) -> DevicePeaks:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet rates to obs/peaks.PEAKS"
        ) from None


def nn_flops(m: int, n: int, d: int = 3) -> float:
    """Arithmetic of one brute-force NN call in difference form: per pair,
    d subtractions, d multiplies and d − 1 adds (the compare is not counted)."""
    return float(m) * n * (3 * d - 1)
