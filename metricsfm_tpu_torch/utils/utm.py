"""Lat/Lon <-> UTM conversion with standard ellipsoid table.

Counterpart of metricsfm_tpu/utils/utm.py (host math, copied so the port
imports nothing of the JAX package), which replaces the reference's
SfM/src/utils/converter_utm_latlon.{h,cpp} + ellipsoid_utm_info.h (23
reference ellipsoids; WGS-84 default).  Standard transverse-Mercator series
(public geodetic constants/formulae).
"""
from __future__ import annotations

import math
from typing import Tuple

# (name, equatorial radius a, eccentricity squared) — standard geodetic table
ELLIPSOIDS = [
    ("Airy", 6377563.0, 0.00667054),
    ("Australian National", 6378160.0, 0.006694542),
    ("Bessel 1841", 6377397.0, 0.006674372),
    ("Bessel 1841 (Nambia)", 6377484.0, 0.006674372),
    ("Clarke 1866", 6378206.0, 0.006768658),
    ("Clarke 1880", 6378249.0, 0.006803511),
    ("Everest", 6377276.0, 0.006637847),
    ("Fischer 1960 (Mercury)", 6378166.0, 0.006693422),
    ("Fischer 1968", 6378150.0, 0.006693422),
    ("GRS 1967", 6378160.0, 0.006694605),
    ("GRS 1980", 6378137.0, 0.00669438),
    ("Helmert 1906", 6378200.0, 0.006693422),
    ("Hough", 6378270.0, 0.00672267),
    ("International", 6378388.0, 0.00672267),
    ("Krassovsky", 6378245.0, 0.006693422),
    ("Modified Airy", 6377340.0, 0.00667054),
    ("Modified Everest", 6377304.0, 0.006637847),
    ("Modified Fischer 1960", 6378155.0, 0.006693422),
    ("South American 1969", 6378160.0, 0.006694542),
    ("WGS 60", 6378165.0, 0.006693422),
    ("WGS 66", 6378145.0, 0.006694542),
    ("WGS-72", 6378135.0, 0.006694318),
    ("WGS-84", 6378137.0, 0.00669438),
]
WGS84 = 22  # index into ELLIPSOIDS

_K0 = 0.9996


def ll_to_utm(lat: float, lon: float, ellipsoid: int = WGS84
              ) -> Tuple[float, float, str]:
    """(lat, lon) degrees -> (easting, northing, zone string)."""
    _, a, ecc2 = ELLIPSOIDS[ellipsoid]
    lon = (lon + 180.0) % 360.0 - 180.0
    phi = math.radians(lat)
    lam = math.radians(lon)
    zone = int((lon + 180.0) / 6.0) + 1
    if 56.0 <= lat < 64.0 and 3.0 <= lon < 12.0:
        zone = 32
    if 72.0 <= lat < 84.0:
        if 0.0 <= lon < 9.0:
            zone = 31
        elif 9.0 <= lon < 21.0:
            zone = 33
        elif 21.0 <= lon < 33.0:
            zone = 35
        elif 33.0 <= lon < 42.0:
            zone = 37
    lam0 = math.radians((zone - 1) * 6 - 180 + 3)

    ep2 = ecc2 / (1 - ecc2)
    N = a / math.sqrt(1 - ecc2 * math.sin(phi) ** 2)
    T = math.tan(phi) ** 2
    C = ep2 * math.cos(phi) ** 2
    A = math.cos(phi) * (lam - lam0)
    M = a * ((1 - ecc2 / 4 - 3 * ecc2 ** 2 / 64 - 5 * ecc2 ** 3 / 256) * phi
             - (3 * ecc2 / 8 + 3 * ecc2 ** 2 / 32 + 45 * ecc2 ** 3 / 1024)
             * math.sin(2 * phi)
             + (15 * ecc2 ** 2 / 256 + 45 * ecc2 ** 3 / 1024) * math.sin(4 * phi)
             - (35 * ecc2 ** 3 / 3072) * math.sin(6 * phi))
    east = _K0 * N * (A + (1 - T + C) * A ** 3 / 6
                      + (5 - 18 * T + T * T + 72 * C - 58 * ep2) * A ** 5 / 120) \
        + 500000.0
    north = _K0 * (M + N * math.tan(phi) * (
        A * A / 2 + (5 - T + 9 * C + 4 * C * C) * A ** 4 / 24
        + (61 - 58 * T + T * T + 600 * C - 330 * ep2) * A ** 6 / 720))
    band = "CDEFGHJKLMNPQRSTUVWX"[min(max(int((lat + 80) / 8), 0), 19)]
    if lat < 0:
        north += 10000000.0
    return east, north, f"{zone}{band}"


def utm_to_ll(east: float, north: float, zone: str, ellipsoid: int = WGS84
              ) -> Tuple[float, float]:
    """(easting, northing, zone like '17N') -> (lat, lon) degrees."""
    _, a, ecc2 = ELLIPSOIDS[ellipsoid]
    zone_num = int("".join(ch for ch in zone if ch.isdigit()))
    band = zone[-1].upper()
    northern = band >= "N"
    x = east - 500000.0
    y = north if northern else north - 10000000.0

    ep2 = ecc2 / (1 - ecc2)
    e1 = (1 - math.sqrt(1 - ecc2)) / (1 + math.sqrt(1 - ecc2))
    M = y / _K0
    mu = M / (a * (1 - ecc2 / 4 - 3 * ecc2 ** 2 / 64 - 5 * ecc2 ** 3 / 256))
    phi1 = mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * math.sin(2 * mu) \
        + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * math.sin(4 * mu) \
        + (151 * e1 ** 3 / 96) * math.sin(6 * mu) \
        + (1097 * e1 ** 4 / 512) * math.sin(8 * mu)
    N1 = a / math.sqrt(1 - ecc2 * math.sin(phi1) ** 2)
    T1 = math.tan(phi1) ** 2
    C1 = ep2 * math.cos(phi1) ** 2
    R1 = a * (1 - ecc2) / (1 - ecc2 * math.sin(phi1) ** 2) ** 1.5
    D = x / (N1 * _K0)
    lat = phi1 - (N1 * math.tan(phi1) / R1) * (
        D * D / 2 - (5 + 3 * T1 + 10 * C1 - 4 * C1 * C1 - 9 * ep2) * D ** 4 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1 * T1 - 252 * ep2 - 3 * C1 * C1)
        * D ** 6 / 720)
    lon = (D - (1 + 2 * T1 + C1) * D ** 3 / 6
           + (5 - 2 * C1 + 28 * T1 - 3 * C1 * C1 + 8 * ep2 + 24 * T1 * T1)
           * D ** 5 / 120) / math.cos(phi1)
    lam0 = (zone_num - 1) * 6 - 180 + 3
    return math.degrees(lat), math.degrees(lon) + lam0
