"""One image through the whole smoothing run (quantsmooth.h:2404-2878,
the run without a progress callback): per component the dequantization
with its guard, the pixel bootstrap, ``niter`` passes, the guard's
fallback and the +-1023 clamp; between the components the colour paths
in block form (sampling factors up to 2): the downsampled luma that
JOINT_YUV reads and the chroma that UPSAMPLE_UV brings to luma size."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import passes
from .tables import (ITER_MAX, JOINT_YUV, LOW_QUALITY, NO_REBALANCE,
                     NO_REBALANCE_UV, UPSAMPLE_UV, quant_tables,
                     solver_tables)

I16 = torch.int16
I32 = torch.int32


@dataclass
class Component:
    h_samp: int
    v_samp: int
    hb: int
    wb: int
    quantval: np.ndarray    # uint16[64], natural order
    coefs: np.ndarray       # int16[hb, wb, 64], as entropy-decoded


@dataclass
class Image:
    width: int
    height: int
    ycbcr: bool
    comps: list             # of Component


@dataclass
class Result:
    coefs: list             # int16[hb, wb, 64] per component
    upsampled: tuple        # (cb, cr) int16 at luma size, or None
    stop: int


def _dequant(coef16, qraw):
    """int16[B, 64] -> (int16-wrapped int32[64, B], guard tripped)
    (quantsmooth.h:2596-2610)."""
    prod = (coef16.to(I32).T * qraw[:, None]).contiguous()
    bad = bool(((prod + 0x800) >> 12).ne(0).any())
    return prod.to(I16).to(I32), bad


def _smooth_component(coef16, qraw, tabs, tab, image2, *, hb, wb, flags,
                      niter, luma, extra_refresh, ft):
    """-> (clamped int16[B, 64], the final pixels int32[64, B] when
    extra_refresh, else None, guard tripped)."""
    div, x1, qshr = tabs
    coef, bad = _dequant(coef16, qraw)
    coef_dq = coef
    do_reb = not (flags & NO_REBALANCE
                  or (not luma and flags & NO_REBALANCE_UV))
    pix = passes.idct64(coef)
    for it in range(niter):
        coef = passes.smooth_pass(coef, pix, image2, div, x1, qshr, tab,
                                  flags, ft, do_reb, hb, wb)
        if it < niter - 1 or extra_refresh:
            pix = passes.idct64(coef)
    if bad:
        coef = coef_dq
    out = torch.clamp(coef, -1023, 1023).T.to(I16)
    return out, (pix if extra_refresh else None), bad


def smooth_image(img: Image, quality_flags: int, niter: int, device,
                 float_dtype=torch.float32) -> Result:
    """The smoothed coefficient planes of ``img`` (quant = 1 semantics),
    the upsampled chroma planes and the stop flag, as the command-line
    tool computes them, in plain torch on ``device``."""
    flags = quality_flags
    comps = img.comps
    coefs = [np.asarray(c.coefs, np.int16).copy() for c in comps]
    need_ds = (bool(flags & (JOINT_YUV | UPSAMPLE_UV)) and img.ycbcr
               and len(comps) >= 3
               and all(c.h_samp == 1 and c.v_samp == 1 for c in comps[1:3]))
    num_iter = min(max(niter, 0), ITER_MAX)
    if num_iter <= 0 and not (flags & UPSAMPLE_UV and need_ds):
        return Result(coefs, None, 0)
    ws, hs = comps[0].h_samp, comps[0].v_samp
    if need_ds and (ws > 2 or hs > 2):
        raise NotImplementedError("sampling factors above 2 take the plane "
                                  "form, which this reference leaves out")
    ft = float_dtype
    tab = None
    if not flags & LOW_QUALITY:
        tab = torch.from_numpy(solver_tables(flags)).to(device, ft)

    static_stop = stop = False
    image1 = image2 = None
    ups = {}
    planned = []
    for ci, c in enumerate(comps):
        qraw = np.asarray(c.quantval, np.int32)
        if not qraw.any():
            continue            # no quant table came with this component
        extra = int(image1 is not None or (ci == 0 and need_ds))
        niter2 = num_iter
        val = int(np.bitwise_or.reduce(qraw))
        if val <= 1:
            niter2 = 0          # already processed (quantsmooth.h:2500)
        if val >= 0x800:
            static_stop = True  # crafted file (2502-2504)
        if niter2 + extra == 0:
            continue            # (2542)
        planned.append(ci)
        coef16 = torch.from_numpy(np.ascontiguousarray(
            coefs[ci].reshape(-1, 64))).to(device)
        qraw_t = torch.from_numpy(qraw).to(device)
        dq16 = (coef16.to(I32) * qraw_t[None, :]).to(I16)
        if static_stop:
            coefs[ci] = dq16.cpu().numpy().reshape(c.hb, c.wb, 64)
            continue
        tabs = tuple(torch.from_numpy(t).to(device)
                     for t in quant_tables(qraw))
        joint = image2 is not None and bool(flags & JOINT_YUV)
        out, pix, bad = _smooth_component(
            coef16, qraw_t, tabs, tab, image2 if joint else None, hb=c.hb,
            wb=c.wb, flags=flags, niter=niter2,
            luma=ci == 0 or not img.ycbcr, extra_refresh=extra, ft=ft)
        coefs[ci] = (dq16 if stop else out).cpu().numpy().reshape(
            c.hb, c.wb, 64)
        stop = stop or bad
        if image1 is not None:
            ups[ci] = _upsample(pix, image2, image1, img, ft)
        elif ci == 0 and need_ds and len(comps) > 1:
            image1, image2 = _luma_products(pix, img, flags)
    stop = int(static_stop or stop)
    upsampled = None
    if not stop and 1 in ups and 2 in ups:
        upsampled = (ups[1], ups[2])
    return Result(coefs, upsampled, stop)


def _luma_products(pix, img, flags):
    """After the luma: (its pixels when UPSAMPLE_UV reads them, else
    None; the downsampled luma as halos int32[100, Bc])."""
    y, cb = img.comps[0], img.comps[1]
    ds = passes.downsample_blocks(pix.reshape(8, 8, -1), y.hb, y.wb, cb.hb,
                                  cb.wb, y.h_samp, y.v_samp)
    halo = passes.halo10(ds, cb.hb, cb.wb).reshape(100, -1)
    keep = (flags & UPSAMPLE_UV) and not (y.h_samp == 1 and y.v_samp == 1)
    return (pix if keep else None), halo


def _upsample(pix, image2, image1, img, ft):
    """One chroma component at luma size: its final pixels, the
    downsampled luma halos and the luma pixels -> int16[hb_l, wb_l, 64]
    (quantsmooth.h:2732-2750: FDCT of the centred blocks, roundf, C
    cast)."""
    y, c = img.comps[0], img.comps[1]
    up = passes.upsample_chroma(
        passes.halo10(pix.reshape(8, 8, -1), c.hb, c.wb),
        image2.reshape(10, 10, -1), image1.reshape(8, 8, -1), img.width,
        img.height, y.h_samp, y.v_samp, y.hb, y.wb, c.hb, c.wb, ft)
    f = passes.fdct((up - 128).to(ft)).reshape(64, -1)
    out = passes.c_to_i32(passes.roundf(f)).to(I16).T
    return out.cpu().numpy().reshape(y.hb, y.wb, 64)
