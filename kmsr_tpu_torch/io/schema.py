"""Data-model constants shared by the whole framework.

The reference pipeline's de-facto data model (see reference
`A_00_patch_cutter_universal.py:29-36,224-260`, `README.MD:1-11`) is a
NetCDF4 file with hierarchical groups holding five TOA-radiance spectral
bands as float32 `[H, W]` rasters (channel-first `[5, H, W]` when stacked),
`-9999.0` marking invalid pixels.
"""
from __future__ import annotations

import dataclasses

# Five spectral bands (nm): blue, blue-green, green, red, NIR.
BAND_NAMES = (
    "L_TOA_443",
    "L_TOA_490",
    "L_TOA_555",
    "L_TOA_660",
    "L_TOA_865",
)
NUM_BANDS = len(BAND_NAMES)
NIR_BAND_INDEX = 4  # 865 nm band used for the water mask
INVALID_VALUE = -9999.0
RADIANCE_UNITS = "W m-2 sr-1 um-1"

# Group names used by the pipeline stages.
GROUP_GEO = "geophysical_data"    # raw TOA radiance
GROUP_NAV = "navigation_data"     # per-pixel latitude / longitude
GROUP_DENOISED = "denoised"       # NLM-denoised bands
GROUP_BLURRED = "blurred"         # kernel-blurred + downsampled bands
GROUP_HR = "hr"                   # high-resolution training target
GROUP_LR = "lr"                   # low-resolution training input

# Landsat OLI band number -> centre wavelength (nm) -> canonical band name.
# Reference: `A_00Landsat_cal_rad.py:50-51` (482->490, 561->555, 655->660).
LANDSAT_BAND_WAVELENGTHS = {
    1: 443, 2: 482, 3: 561, 4: 655, 5: 865,
    6: 1609, 7: 2200, 8: 590, 9: 1373, 10: 10895, 11: 12005,
}
WAVELENGTH_TO_BAND_NAME = {
    443: "L_TOA_443",
    482: "L_TOA_490",
    561: "L_TOA_555",
    655: "L_TOA_660",
    865: "L_TOA_865",
}


@dataclasses.dataclass(frozen=True)
class PatchProvenance:
    """Root attributes stamped on every cut patch file.

    Mirrors the reference's patch attrs (`A_00_patch_cutter_universal.py:
    229-237`): grid indices, pixel offsets, patch size and source file.
    """

    source_file: str
    grid_i: int
    grid_j: int
    h_offset: int
    w_offset: int
    patch_size: int
    invalid_value: float = INVALID_VALUE
    description: str = "Patch extracted from Landsat/GOCI-2 L1B data"

    def as_attrs(self) -> dict:
        return dataclasses.asdict(self)
