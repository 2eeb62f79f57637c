from .schema import (
    BAND_NAMES,
    NUM_BANDS,
    NIR_BAND_INDEX,
    INVALID_VALUE,
    GROUP_GEO,
    GROUP_NAV,
    GROUP_DENOISED,
    GROUP_BLURRED,
    GROUP_HR,
    GROUP_LR,
    PatchProvenance,
)
from .ncio import (
    NCFile,
    read_band_stack,
    write_band_stack,
    read_nav,
    copy_file_with_groups,
)
