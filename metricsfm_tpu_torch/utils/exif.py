"""EXIF metadata extraction: focal length in pixels, GPS, maker/model.

Replaces the reference's easyexif wrapper (SfM/src/utils/exif_reader.{h,cpp},
used database.cc:249-281: focal mm -> pixels via FocalPlaneXResolution or
sensor width, GPS lat/lon/alt).  Uses PIL's EXIF support.
"""
from __future__ import annotations

from typing import Optional


def _ratio(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        try:
            return v[0] / v[1]
        except Exception:
            return 0.0


def _dms_to_deg(dms, ref) -> float:
    try:
        deg = _ratio(dms[0]) + _ratio(dms[1]) / 60.0 + _ratio(dms[2]) / 3600.0
        if ref in (b"S", "S", b"W", "W"):
            deg = -deg
        return deg
    except Exception:
        return 0.0


def extract_image_info(path: str) -> dict:
    """Returns {focal_px, focal_mm, gps (lat, lon, alt), maker, model, w, h}.

    focal_px derivation (mirrors database.cc:263-277 logic):
      1. FocalLengthIn35mmFilm: f_px = f35/36 * width
      2. FocalLength + FocalPlaneXResolution (per inch/cm): f_px = f_mm * res
      3. else 0 (caller falls back to 1.2*max(w,h), ref camera hint)
    """
    out = {"focal_px": 0.0, "focal_mm": 0.0, "gps": (0.0, 0.0, 0.0),
           "maker": "", "model": "", "width": 0, "height": 0}
    try:
        from PIL import Image
        from PIL.ExifTags import TAGS, GPSTAGS
        im = Image.open(path)
        out["width"], out["height"] = im.size
        raw = im.getexif()
        if raw is None:
            return out
        exif = {TAGS.get(k, k): v for k, v in raw.items()}
        # PIL stores photo sub-ifd separately
        try:
            sub = raw.get_ifd(0x8769)
            exif.update({TAGS.get(k, k): v for k, v in sub.items()})
        except Exception:
            pass
        out["maker"] = str(exif.get("Make", ""))
        out["model"] = str(exif.get("Model", ""))
        f_mm = _ratio(exif.get("FocalLength", 0.0))
        out["focal_mm"] = f_mm
        f35 = _ratio(exif.get("FocalLengthIn35mmFilm", 0.0))
        if f35 > 0:
            out["focal_px"] = f35 / 36.0 * out["width"]
        elif f_mm > 0:
            res = _ratio(exif.get("FocalPlaneXResolution", 0.0))
            unit = exif.get("FocalPlaneResolutionUnit", 2)
            if res > 0:
                per_mm = res / 25.4 if unit == 2 else res / 10.0
                out["focal_px"] = f_mm * per_mm
        try:
            gps_ifd = raw.get_ifd(0x8825)
            gps = {GPSTAGS.get(k, k): v for k, v in gps_ifd.items()}
            if gps:
                lat = _dms_to_deg(gps.get("GPSLatitude", ()),
                                  gps.get("GPSLatitudeRef", "N"))
                lon = _dms_to_deg(gps.get("GPSLongitude", ()),
                                  gps.get("GPSLongitudeRef", "E"))
                alt = _ratio(gps.get("GPSAltitude", 0.0))
                out["gps"] = (lat, lon, alt)
        except Exception:
            pass
    except Exception:
        pass
    return out
