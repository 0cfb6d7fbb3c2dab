"""WGS-84 geodesy: LLA -> ECEF -> local ENU.

Replacement for GeographicLib's ``LocalCartesian`` used by the reference GPS
path (``liorf/src/mapOptmization.cpp:159,286-289``): the first fix
becomes the datum and subsequent fixes are expressed in the local
east-north-up frame.

This runs host-side in numpy float64: ECEF coordinates are ~6.4e6 m, so
float32 differencing would lose ~0.5 m — far above GPS noise. The tiny
per-fix conversion never belongs on the device hot path.
"""

from __future__ import annotations

import numpy as np

# WGS-84 ellipsoid
_A = 6378137.0  # semi-major axis [m]
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)  # first eccentricity squared


def lla_to_ecef(lat_deg, lon_deg, alt) -> np.ndarray:
    """Geodetic degrees/meters -> ECEF meters. Accepts batched arrays."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat * sin_lat)
    x = (n + alt) * cos_lat * cos_lon
    y = (n + alt) * cos_lat * sin_lon
    z = (n * (1.0 - _E2) + alt) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_enu_matrix(lat_deg, lon_deg) -> np.ndarray:
    """Rotation from ECEF deltas to local ENU at the datum."""
    lat = np.deg2rad(float(lat_deg))
    lon = np.deg2rad(float(lon_deg))
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    sin_lon, cos_lon = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-sin_lon, cos_lon, 0.0],
            [-sin_lat * cos_lon, -sin_lat * sin_lon, cos_lat],
            [cos_lat * cos_lon, cos_lat * sin_lon, sin_lat],
        ],
        dtype=np.float64,
    )


def lla_to_enu(lat_deg, lon_deg, alt, datum_lat_deg, datum_lon_deg, datum_alt) -> np.ndarray:
    """LLA -> ENU meters relative to the datum fix. Batched over leading dims."""
    p = lla_to_ecef(lat_deg, lon_deg, alt)
    p0 = lla_to_ecef(datum_lat_deg, datum_lon_deg, datum_alt)
    Rm = ecef_to_enu_matrix(datum_lat_deg, datum_lon_deg)
    return (p - p0) @ Rm.T


class LocalCartesian:
    """Stateful datum holder mirroring GeographicLib::LocalCartesian usage."""

    def __init__(self):
        self._datum = None

    @property
    def initialized(self) -> bool:
        return self._datum is not None

    def reset(self, lat_deg, lon_deg, alt):
        self._datum = (float(lat_deg), float(lon_deg), float(alt))

    def forward(self, lat_deg, lon_deg, alt) -> np.ndarray:
        if self._datum is None:
            self.reset(lat_deg, lon_deg, alt)
        d = self._datum
        return lla_to_enu(lat_deg, lon_deg, alt, d[0], d[1], d[2])
