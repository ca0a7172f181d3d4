"""The comparison that decides ``correct``: every kept result of the
window against the plain reference of the same input, value for value.

The configuration's guarantee is bit-exactness (the command-line tool's
output, coefficient for coefficient), so every limit is 0: the count of
int16 coefficients that differ in the planes of every component, in the
upsampled Cb/Cr planes where the configuration makes them, and the count
of images whose stop flag differs.  A plane of the wrong shape, or one
side's upsampled planes missing, counts all its values.
"""

from __future__ import annotations

import numpy as np


def _diff(a, b) -> int:
    if a is None and b is None:
        return 0
    if a is None or b is None:
        return int((a if b is None else b).size)
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int(np.count_nonzero(a != b))


def compare(result, ref) -> dict:
    """Mismatch counts of one image's result against its reference."""
    n = len(ref.coefs)
    coef = sum(_diff(result.coefs[i] if i < len(result.coefs) else None,
                     ref.coefs[i]) for i in range(n))
    ups_r = result.upsampled or (None, None)
    ups_f = ref.upsampled or (None, None)
    return {"coef_mismatch": coef,
            "upsampled_mismatch": sum(_diff(a, b)
                                      for a, b in zip(ups_r, ups_f)),
            "stop_mismatch": int(int(result.stop) != int(ref.stop))}


def checks(kept, refs, min_images: int, errors: int) -> tuple:
    """(checks, failed images): ``kept`` the window's kept (batch,
    results); ``refs`` the reference of each pool index.  Each check is
    {"value": v, "max": limit} or {"value": v, "min": limit}."""
    total = {"coef_mismatch": 0, "upsampled_mismatch": 0,
             "stop_mismatch": 0}
    images = failed = 0
    for b, results in kept:
        for i, res in zip(b.images, results):
            d = compare(res, refs[i])
            for k, v in d.items():
                total[k] += v
            failed += any(d.values())
            images += 1
    out = {k: {"value": v, "max": 0} for k, v in total.items()}
    out["images_compared"] = {"value": images, "min": min_images}
    out["errors"] = {"value": errors, "max": 0}
    return out, failed


def passed(check: dict) -> bool:
    if "max" in check:
        return check["value"] <= check["max"]
    return check["value"] >= check["min"]


def lines(checks_: dict) -> list:
    return [f"check {k} = {c['value']} (limit: "
            f"{'<=' if 'max' in c else '>='} {c.get('max', c.get('min'))})"
            for k, c in checks_.items()]
