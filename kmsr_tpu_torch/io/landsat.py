"""Landsat 8/9 Collection-2 L1 ingest: MTL calibration -> grouped NetCDF.

The port's copy of `kmsr_tpu.io.landsat` (host numpy; PIL imported at
first use, the `.nc` written through this package's `io.ncio`).

Capability parity with `A_00Landsat_cal_rad.py:30-192`:
  * parse the `*_MTL.txt` key=value file;
  * per band: DN -> TOA radiance (M*DN + A, mode="rad") or TOA reflectance
    ((M*DN + A)/sin(sun_elevation), mode="ref"); DN==0 -> -9999 nodata;
  * per-pixel WGS84 lat/lon grids from the projected grid (fast row-wise
    path for north-up imagery);
  * write `navigation_data` (latitude/longitude) + `geophysical_data`
    (L_TOA_*) groups with compression.

This environment has no rasterio/GDAL, so this module carries its own
minimal GeoTIFF reader (PIL for tags + cv2/PIL for pixels) and a
closed-form UTM -> WGS84 inverse transverse-Mercator transform (WGS84
ellipsoid, standard series — sub-meter accuracy), sufficient for Landsat
C2 L1 products. North-up rasters take a fast separable pixel-center path;
rotated/sheared rasters take the general per-pixel affine path
(x = a*col + b*row + c, y = d*col + e*row + f), matching the reference's
general branch (A_00Landsat_cal_rad.py:134-143). Non-UTM CRS rasters are
rejected with a clear error.
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .ncio import NCFile
from .schema import (
    INVALID_VALUE,
    LANDSAT_BAND_WAVELENGTHS,
    RADIANCE_UNITS,
    WAVELENGTH_TO_BAND_NAME,
)

# WGS84 ellipsoid
_A = 6378137.0
_F = 1 / 298.257223563
_E2 = _F * (2 - _F)
_K0 = 0.9996
_FALSE_EASTING = 500_000.0
_FALSE_NORTHING_S = 10_000_000.0


def parse_mtl(mtl_path: str) -> dict:
    """Parse an MTL key = value file into a flat dict of strings."""
    kv: dict[str, str] = {}
    with open(mtl_path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            if " = " in line:
                k, v = line.strip().split(" = ", 1)
                kv[k.strip()] = v.strip().strip('"')
    return kv


def find_mtl(root: str) -> str:
    for fn in os.listdir(root):
        if fn.upper().endswith("_MTL.TXT"):
            return os.path.join(root, fn)
    raise FileNotFoundError(f"no *_MTL.txt in {root}")


def find_band_file(root: str, band: int) -> str:
    suffix = f"_B{band}.TIF".lower()
    for fn in os.listdir(root):
        if fn.lower().endswith(suffix):
            return os.path.join(root, fn)
    raise FileNotFoundError(f"no *_B{band}.TIF in {root}")


# ------------------------------------------------------------- geotiff bits
def read_geotiff(path: str) -> tuple[np.ndarray, tuple, Optional[int]]:
    """Read (pixels, affine transform (a,b,c,d,e,f), epsg code).

    Transform convention (GDAL-style): x = c + col*a + row*b;
    y = f + col*d + row*e, for pixel CORNERS (we offset to centers later).
    """
    from PIL import Image

    with Image.open(path) as img:
        tags = dict(img.tag_v2) if hasattr(img, "tag_v2") else {}
        data = np.array(img)
    transform = None
    if 33550 in tags and 33922 in tags:  # ModelPixelScale + ModelTiepoint
        sx, sy = float(tags[33550][0]), float(tags[33550][1])
        tp = tags[33922]
        i, j, _, x, y = (float(tp[0]), float(tp[1]), float(tp[2]),
                         float(tp[3]), float(tp[4]))
        c = x - i * sx
        f = y + j * sy
        transform = (sx, 0.0, c, 0.0, -sy, f)
    elif 34264 in tags:  # ModelTransformation
        m = [float(v) for v in tags[34264]]
        transform = (m[0], m[1], m[3], m[4], m[5], m[7])
    epsg = None
    if 34735 in tags:  # GeoKeyDirectory
        gk = list(tags[34735])
        for i in range(4, len(gk), 4):
            key_id, loc, _count, value = gk[i : i + 4]
            if key_id in (3072, 2048) and loc == 0:  # ProjectedCSType / GeographicType
                epsg = int(value)
                if key_id == 3072:
                    break
    if transform is None:
        raise ValueError(f"{path}: no geo-transform tags (33550/33922 or 34264)")
    return data, transform, epsg


def utm_epsg_to_zone(epsg: int) -> tuple[int, bool]:
    """EPSG 326xx/327xx -> (zone, northern)."""
    if 32601 <= epsg <= 32660:
        return epsg - 32600, True
    if 32701 <= epsg <= 32760:
        return epsg - 32700, False
    raise ValueError(f"EPSG {epsg} is not a UTM WGS84 code")


def utm_to_wgs84(
    easting: np.ndarray, northing: np.ndarray, zone: int, northern: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse transverse Mercator (WGS84), vectorized. Returns (lon, lat)
    in degrees."""
    x = np.asarray(easting, np.float64) - _FALSE_EASTING
    y = np.asarray(northing, np.float64)
    if not northern:
        y = y - _FALSE_NORTHING_S
    e2 = _E2
    ep2 = e2 / (1 - e2)
    m = y / _K0
    mu = m / (_A * (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256))
    e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
    phi1 = (
        mu
        + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
        + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
        + (151 * e1**3 / 96) * np.sin(6 * mu)
        + (1097 * e1**4 / 512) * np.sin(8 * mu)
    )
    sin1, cos1 = np.sin(phi1), np.cos(phi1)
    c1 = ep2 * cos1**2
    t1 = np.tan(phi1) ** 2
    n1 = _A / np.sqrt(1 - e2 * sin1**2)
    r1 = _A * (1 - e2) / (1 - e2 * sin1**2) ** 1.5
    d = x / (n1 * _K0)
    lat = phi1 - (n1 * np.tan(phi1) / r1) * (
        d**2 / 2
        - (5 + 3 * t1 + 10 * c1 - 4 * c1**2 - 9 * ep2) * d**4 / 24
        + (61 + 90 * t1 + 298 * c1 + 45 * t1**2 - 252 * ep2 - 3 * c1**2)
        * d**6
        / 720
    )
    lon = (
        d
        - (1 + 2 * t1 + c1) * d**3 / 6
        + (5 - 2 * c1 + 28 * t1 - 3 * c1**2 + 8 * ep2 + 24 * t1**2) * d**5 / 120
    ) / cos1
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    return np.degrees(lon) + math.degrees(lon0), np.degrees(lat)


def wgs84_to_utm(
    lon: np.ndarray, lat: np.ndarray, zone: int, northern: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Forward transverse Mercator (for round-trip testing)."""
    lon = np.radians(np.asarray(lon, np.float64))
    lat = np.radians(np.asarray(lat, np.float64))
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    e2 = _E2
    ep2 = e2 / (1 - e2)
    n = _A / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    t = np.tan(lat) ** 2
    c = ep2 * np.cos(lat) ** 2
    a_ = np.cos(lat) * (lon - lon0)
    m = _A * (
        (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256) * lat
        - (3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024) * np.sin(2 * lat)
        + (15 * e2**2 / 256 + 45 * e2**3 / 1024) * np.sin(4 * lat)
        - (35 * e2**3 / 3072) * np.sin(6 * lat)
    )
    x = _K0 * n * (
        a_
        + (1 - t + c) * a_**3 / 6
        + (5 - 18 * t + t**2 + 72 * c - 58 * ep2) * a_**5 / 120
    ) + _FALSE_EASTING
    y = _K0 * (
        m
        + n * np.tan(lat)
        * (
            a_**2 / 2
            + (5 - t + 9 * c + 4 * c**2) * a_**4 / 24
            + (61 - 58 * t + t**2 + 600 * c - 330 * ep2) * a_**6 / 720
        )
    )
    if not northern:
        y = y + _FALSE_NORTHING_S
    return x, y


# ------------------------------------------------------------- calibration
def calc_landsat_toa(
    root: str,
    bands: Sequence[int],
    mode: str = "rad",
    out_dir: Optional[str] = None,
) -> str:
    """Calibrate Landsat DN -> TOA and write grouped NetCDF.

    Returns the output file path.
    """
    kv = parse_mtl(find_mtl(root))
    sun_elev = float(kv["SUN_ELEVATION"])
    product_id = kv.get("LANDSAT_PRODUCT_ID", "Landsat_C2_L1")

    band_data: dict[int, np.ndarray] = {}
    first = None
    for b in bands:
        data, transform, epsg = read_geotiff(find_band_file(root, b))
        dn = data.astype(np.float32)
        mask = data == 0
        if mode == "ref":
            m = float(kv[f"REFLECTANCE_MULT_BAND_{b}"])
            a = float(kv[f"REFLECTANCE_ADD_BAND_{b}"])
            sin_el = max(math.sin(math.radians(sun_elev)), 1e-6)
            arr = (m * dn + a) / sin_el
        else:
            m = float(kv[f"RADIANCE_MULT_BAND_{b}"])
            a = float(kv[f"RADIANCE_ADD_BAND_{b}"])
            arr = m * dn + a
        arr = arr.astype(np.float32)
        arr[mask] = INVALID_VALUE
        wl = LANDSAT_BAND_WAVELENGTHS[b]
        band_data[wl] = arr
        if first is None:
            first = (transform, epsg, arr.shape)
        elif first[2] != arr.shape:
            raise ValueError(f"band {b} shape {arr.shape} != {first[2]}")

    if first is None:
        raise RuntimeError("no bands read")
    (a_, b_, c_, d_, e_, f_), epsg, (height, width) = first
    if epsg is None:
        raise ValueError("no EPSG code in GeoTIFF; cannot compute lat/lon")
    zone, northern = utm_epsg_to_zone(epsg)
    cols = np.arange(width, dtype=np.float64) + 0.5
    rows = np.arange(height, dtype=np.float64) + 0.5
    if abs(b_) <= 1e-12 and abs(d_) <= 1e-12:
        # fast north-up path: separable pixel centers, one meshgrid
        # (A_00Landsat_cal_rad.py:119-133 equivalent)
        xs = c_ + cols * a_
        ys = f_ + rows * e_
        xg, yg = np.meshgrid(xs, ys)
    else:
        # general rotated/sheared path: full per-pixel affine
        # x = a*col + b*row + c, y = d*col + e*row + f
        # (A_00Landsat_cal_rad.py:134-143 equivalent — the reference
        # transforms every pixel center through the raster transform)
        cg, rg = np.meshgrid(cols, rows)
        xg = c_ + cg * a_ + rg * b_
        yg = f_ + cg * d_ + rg * e_
    lon, lat = utm_to_wgs84(xg, yg, zone, northern)

    out_dir_path = Path(out_dir) if out_dir else Path("output/img/1_Lt/nc")
    out_dir_path.mkdir(parents=True, exist_ok=True)
    out_path = out_dir_path / (
        f"{product_id}_TOA_{mode.upper()}_B{'-'.join(map(str, bands))}_native.nc"
    )
    with NCFile(out_path, "w") as f:
        f.create_variable(
            "navigation_data", "latitude", lat.astype(np.float32), dims=("y", "x"),
            attrs={"long_name": "latitude", "units": "degrees_north",
                   "standard_name": "latitude"},
            fill_value=None,
        )
        f.create_variable(
            "navigation_data", "longitude", lon.astype(np.float32), dims=("y", "x"),
            attrs={"long_name": "longitude", "units": "degrees_east",
                   "standard_name": "longitude"},
            fill_value=None,
        )
        for wl, arr in band_data.items():
            if wl in WAVELENGTH_TO_BAND_NAME:
                name = WAVELENGTH_TO_BAND_NAME[wl]
                f.create_variable(
                    "geophysical_data", name, arr, dims=("y", "x"),
                    attrs={
                        "long_name": f"TOA_{mode}_{wl}nm",
                        "units": RADIANCE_UNITS if mode == "rad" else "1",
                    },
                )
        f.set_attrs(
            {
                "product_id": product_id,
                "source_epsg": epsg,
                "coordinates_crs": "EPSG:4326",
                "history": (
                    "Native-grid TOA; pixel-center coordinates in WGS84; "
                    f"radiometry mode={mode}"
                ),
            }
        )
    return str(out_path)
