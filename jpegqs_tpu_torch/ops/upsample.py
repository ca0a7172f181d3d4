"""UPSAMPLE_UV on padded planes, eager torch: the plane path for
sampling factors above 2, counterpart of
``jpegqs_tpu.ops.upsample.upsample_chroma`` (reference:
quantsmooth.h:1851-2394 upsample_row; integration 2691-2752).

Per low-res pixel the JOINT_YUV regression slope gives
``offset = chroma - luma_ds*scale + 0.5``; the full-res output is
``trunc(luma*scale + offset)`` clamped to 0..255.
"""

from __future__ import annotations

import torch

from .joint import regression_scale

F32 = torch.float32
I32 = torch.int32


def upsample_chroma(padded_chroma, padded_luma_ds, padded_luma, img_w,
                    img_h, ws, hs, hb_l, wb_l):
    """Full-res chroma pixel plane int32[hb_l*8, wb_l*8] from the
    low-res chroma and downsampled-luma padded planes and the full-res
    padded luma plane."""
    w1 = (img_w + ws - 1) // ws
    h1 = (img_h + hs - 1) // hs
    ww, hh = wb_l * 8, hb_l * 8
    w1c = ((w1 + 7) // 8) * 8    # the reference works in 8-column chunks
    dev = padded_chroma.device

    scale = regression_scale(padded_luma_ds, padded_chroma)[:h1, :w1c]
    # offset = chroma - luma_ds*scale + 0.5 (quantsmooth.h:2367)
    imc = padded_chroma[1:h1 + 1, 1:w1c + 1].to(F32)
    iml = padded_luma_ds[1:h1 + 1, 1:w1c + 1].to(F32)
    offset = (imc - iml * scale) + 0.5

    # out = trunc(luma*scale + offset), clamp 0..255
    # (quantsmooth.h:2379-2388)
    lum = torch.zeros((h1 * hs, w1c * ws), dtype=F32, device=dev)
    lum_src = padded_luma[1:, 1:].to(F32)
    ch = min(h1 * hs, lum_src.shape[0])
    cw = min(w1c * ws, lum_src.shape[1])
    lum[:ch, :cw] = lum_src[:ch, :cw]
    scale_hi = scale.repeat_interleave(hs, 0).repeat_interleave(ws, 1)
    offset_hi = offset.repeat_interleave(hs, 0).repeat_interleave(ws, 1)
    val = lum * scale_hi + offset_hi
    out_full = torch.clamp(torch.trunc(val), 0, 255).to(I32)

    out = torch.zeros((hh, ww), dtype=I32, device=dev)
    h_lim = min(h1 * hs, hh)
    w_lim = min(w1c * ws, ww)
    out[:h_lim, :w_lim] = out_full[:h_lim, :w_lim]
    # right-edge replicate from col w1*ws-1 (quantsmooth.h:2390-2393),
    # over the first 8-row chunk only: upsample_row decrements y1 by y0
    # first (quantsmooth.h:1861), a reference quirk kept as is
    if w1 * ws < ww:
        rep_rows = min(min(8, h1) * hs, h_lim)
        out[:rep_rows, w1 * ws:] = out[:rep_rows, w1 * ws - 1:w1 * ws].clone()
    # bottom replicate from row h1*hs-1 (quantsmooth.h:2729-2730)
    if h1 * hs < hh:
        out[h1 * hs:, :] = out[h1 * hs - 1, :][None, :].clone()
    return out
