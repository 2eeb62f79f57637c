"""Water/cloud masking and invalid-value handling.

The port's copy of `kmsr_tpu.data.mask` (host numpy).

Parity: the NIR-band threshold water mask of
`A_00_patch_cutter_universal.py:89-123` (keep pixels whose 865 nm radiance
lies in [threshold_min, threshold_max]; everything else -> NaN in ALL
bands), with INVALID_VALUE (-9999) mapped to NaN first.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..io.schema import INVALID_VALUE, NIR_BAND_INDEX

THRESHOLD_MIN = 1e-6
THRESHOLD_MAX = 7.0


@dataclasses.dataclass(frozen=True)
class MaskStats:
    total_valid: int
    water_pixels: int

    @property
    def water_ratio(self) -> float:
        return self.water_pixels / self.total_valid * 100 if self.total_valid else 0.0


def invalid_to_nan(data: np.ndarray, invalid_value: float = INVALID_VALUE) -> np.ndarray:
    return np.where(data == np.float32(invalid_value), np.nan, data)


def apply_water_mask(
    data: np.ndarray,
    threshold_min: float = THRESHOLD_MIN,
    threshold_max: float = THRESHOLD_MAX,
    nir_index: int = NIR_BAND_INDEX,
    invalid_value: float = INVALID_VALUE,
) -> tuple[np.ndarray, MaskStats]:
    """data: [C, H, W] -> (masked copy with non-water pixels = NaN, stats)."""
    data = invalid_to_nan(np.asarray(data, np.float32), invalid_value)
    nir = data[nir_index]
    water = (nir >= threshold_min) & (nir <= threshold_max)
    masked = np.where(water[None], data, np.nan)
    stats = MaskStats(
        total_valid=int(np.sum(~np.isnan(nir))),
        water_pixels=int(np.sum(water)),
    )
    return masked, stats
