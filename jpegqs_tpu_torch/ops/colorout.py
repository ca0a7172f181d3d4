"""Pixel output on the device: coefficient planes -> RGB / gray pixels,
the port of ``jpegqs_tpu/ops/colorout.py``.

``decode_smoothed`` decodes the smoothed coefficients itself instead of
re-encoding them and running libjpeg's decompressor, reproducing
libjpeg's decompress math bit for bit:

- inverse DCT: jpeg_idct_islow, kernel B1 (``cuda_solver.idct_pix``;
  quant=1, so dequantization is the identity);
- chroma upsampling: h2v2 / h2v1 "fancy" (triangle) upsampling, the
  libjpeg default (do_fancy_upsampling=TRUE); jdsample.c's first/last
  column and row cases coincide with clamped edge replication;
- colour conversion: ycc_rgb fixed point (jdcolor.c build_ycc_rgb_table,
  SCALEBITS=16); the tables are affine in the chroma value, so their
  entries are computed inline.

The upsampling and the colour conversion are exact int32 eager torch
(every product below 2^24), as the JAX package runs them as XLA ops
outside any Pallas kernel.  Given CPU tensors the IDCT runs its plain
version.
"""

from __future__ import annotations

import torch

from . import cuda_solver

I32 = torch.int32

# jdcolor.c fixed-point constants: FIX(x) = round(x * 2^16)
_SCALE = 16
_HALF = 1 << (_SCALE - 1)
_FIX_140200 = int(1.40200 * 65536 + 0.5)
_FIX_177200 = int(1.77200 * 65536 + 0.5)
_FIX_071414 = int(0.71414 * 65536 + 0.5)
_FIX_034414 = int(0.34414 * 65536 + 0.5)


def coefs_to_plane(coef16, hb, wb, oh, ow):
    """int16[hb, wb, 64] quant=1 coefficients -> int32 sample plane
    [oh, ow], cropped to the component's output dims (libjpeg: inverse DCT
    of every block, jdcoefct.c -> jidctint.c)."""
    B = hb * wb
    coef = coef16.to(I32).reshape(B, 64).T.contiguous()
    pix = cuda_solver.idct_pix(coef)
    plane = pix.reshape(8, 8, hb, wb).permute(2, 0, 3, 1).reshape(
        hb * 8, wb * 8)
    return plane[:oh, :ow]


def _h2_fancy_cols(t, bias_even, bias_odd, shift):
    """Shared horizontal doubling of jdsample.c's fancy upsamplers:
    out[2x] = (3*t[x] + t[x-1] + bias_even) >> shift, out[2x+1] =
    (3*t[x] + t[x+1] + bias_odd) >> shift, with the first/last-column
    special cases realized by clamped replication (they coincide:
    e.g. h2v2's (t*4 + 8) >> 4 == (3t + t + 8) >> 4)."""
    left = torch.cat([t[:, :1], t[:, :-1]], dim=1)
    right = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
    even = (3 * t + left + bias_even) >> shift
    odd = (3 * t + right + bias_odd) >> shift
    rows, w = t.shape
    return torch.stack([even, odd], dim=2).reshape(rows, 2 * w)


def fancy_upsample(plane, ws, hs):
    """libjpeg fancy (triangle) chroma upsampling of a downsampled plane
    int32[dh, dw] (jdsample.c h2v2_fancy_upsample / h2v1_fancy_upsample)
    -> int32[hs*dh, ws*dw]; cropping to the image is the caller's job.
    (ws, hs) is (1, 1), (2, 1) or (2, 2): libjpeg has no fancy h1v2 path
    in this generation, and such layouts fall back to the re-encode
    decode."""
    assert (ws, hs) in ((1, 1), (2, 1), (2, 2))
    if ws == 1 and hs == 1:
        return plane
    if hs == 2:
        # vertical triangle: out row 2y weights rows (y-1, y) as (1, 3),
        # out row 2y+1 weights (y, y+1) as (3, 1); image edges replicate
        up = torch.cat([plane[:1], plane[:-1]], dim=0)
        dn = torch.cat([plane[1:], plane[-1:]], dim=0)
        dh, dw = plane.shape
        t = torch.stack([3 * plane + up, 3 * plane + dn], dim=1).reshape(
            2 * dh, dw)
        return _h2_fancy_cols(t, 8, 7, 4)
    # h2v1: out[2x] = (3v + left + 1) >> 2, out[2x+1] = (3v + right + 2) >> 2;
    # first column (v*4+1)>>2 == v and last (v*4+2)>>2 == v, as jdsample.c
    return _h2_fancy_cols(plane, 1, 2, 2)


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert, exactly: r = y + Cr_r_tab[cr],
    g = y + ((Cb_g_tab[cb] + Cr_g_tab[cr]) >> 16), b = y + Cb_b_tab[cb],
    clamped to [0, 255] -> uint8[H, W, 3].  The tables are affine in
    (value - 128), so the entries are computed inline (arithmetic shifts
    match C's RIGHT_SHIFT on two's complement)."""
    xb = cb - 128
    xr = cr - 128
    r = y + ((_FIX_140200 * xr + _HALF) >> _SCALE)
    g = y + ((-_FIX_034414 * xb + _HALF - _FIX_071414 * xr) >> _SCALE)
    b = y + ((_FIX_177200 * xb + _HALF) >> _SCALE)
    return torch.stack([torch.clamp(r, 0, 255), torch.clamp(g, 0, 255),
                        torch.clamp(b, 0, 255)], dim=-1).to(torch.uint8)


def decode_gray(coef16, hb, wb, H, W):
    """One gray coefficient plane int16[hb, wb, 64] -> uint8[H, W]."""
    return coefs_to_plane(coef16, hb, wb, H, W).to(torch.uint8)


def decode_ycc(cy, ccb, ccr, dims, ws, hs, H, W):
    """Full YCbCr decode: 3 coefficient planes (quant=1) -> uint8
    RGB[H, W, 3].  dims = ((hb, wb, oh, ow) per component), oh/ow the
    libjpeg downsampled dims ceil(image * samp / max_samp)."""
    (hby, wby, ohy, owy), (hbc, wbc, ohc, owc), (hbr, wbr, ohr, owr) = dims
    y = coefs_to_plane(cy, hby, wby, ohy, owy)[:H, :W]
    cb = fancy_upsample(coefs_to_plane(ccb, hbc, wbc, ohc, owc), ws,
                        hs)[:H, :W]
    cr = fancy_upsample(coefs_to_plane(ccr, hbr, wbr, ohr, owr), ws,
                        hs)[:H, :W]
    return ycc_to_rgb(y, cb, cr)


def decode(planes, dims, ws, hs, H, W):
    """Pixels of one gray plane or of the Y, Cb, Cr planes (int16[hb, wb,
    64] each) with their ``dims`` (engine.decode_layout): uint8[H, W] or
    uint8[H, W, 3]."""
    if len(planes) == 1:
        return decode_gray(planes[0], dims[0][0], dims[0][1], H, W)
    return decode_ycc(*planes, dims=dims, ws=ws, hs=hs, H=H, W=W)
