"""Seeded synthetic JPEG coefficient images, built in numpy alone.

No libjpeg is involved: a photo-like image (the generator of the test
corpus, ``tests/util.synth_image``) goes through the JFIF RGB->YCbCr
transform, chroma averaging over the sampling cell (2x2 for 4:2:0), an
orthonormal 8x8 DCT and
quantization with the IJG standard tables scaled to the requested
quality (jcparam.c semantics).  The result is a host.jpegio.JpegImage
with the component geometry libjpeg would give the same image, so the
engine sees exactly what a decoder would hand it.
"""

from __future__ import annotations

import numpy as np

from .host.jpegio import ComponentData, JpegImage, JCS_YCBCR

JCS_GRAYSCALE = 1
JCS_RGB = 2
JCS_CMYK = 4

# IJG standard tables (ITU T.81 Annex K.1), natural order
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int64)
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, dtype=np.int64)


KINDS = ("photo", "edges", "flat", "noise")


def synth_image(h, w, seed=0, color=False, kind="photo"):
    """Deterministic synthetic image: uint8 (h, w) gray, (h, w, 3) RGB
    or, with ``color="cmyk"``, (h, w, 4) CMYK -- the generator of the
    test corpus, ``tests/util.synth_image``: "photo" (photo-like
    content, the default), "edges", "flat" or "noise"."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "photo":
        img = (128 + 60 * np.sin(xx * 0.07 + np.sin(yy * 0.05) * 3)
               + 40 * np.cos(yy * 0.11) + 15 * np.sin((xx + yy) * 0.21))
        img += rng.normal(0, 4, (h, w))
        img[(yy.astype(int) // 24 + xx.astype(int) // 31) % 5 == 0] += 55
    elif kind == "edges":
        img = np.full((h, w), 90.0)
        img[(xx.astype(int) // 13) % 2 == 0] += 100
        img[(yy.astype(int) // 9) % 3 == 0] -= 60
        img += rng.normal(0, 2, (h, w))
    elif kind == "flat":
        img = np.full((h, w), 130.0) + rng.normal(0, 1.5, (h, w))
    elif kind == "noise":
        img = rng.uniform(0, 255, (h, w))
    else:
        raise ValueError(kind)
    g = np.clip(img, 0, 255).astype(np.uint8)
    if not color:
        return g
    r = np.clip(img + 30 * np.sin(xx * 0.03), 0, 255).astype(np.uint8)
    b = np.clip(img - 25 * np.cos(yy * 0.04), 0, 255).astype(np.uint8)
    if color == "cmyk":
        k = np.clip(255 - img * 0.7, 0, 255).astype(np.uint8)
        return np.stack([r, g, b, k], axis=-1)
    return np.stack([r, g, b], axis=-1)


def quality_table(base, quality):
    """jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)


def _dct_matrix():
    n = np.arange(8)
    m = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * 0.5
    m[0] *= np.sqrt(0.5)
    return m


def _plane_coefs(plane, hb, wb, qtbl):
    """Level-shifted, edge-padded plane -> quantized int16[hb, wb, 64]."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128.0,
               ((0, hb * 8 - h), (0, wb * 8 - w)), mode="edge")
    blocks = p.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
    m = _dct_matrix()
    dct = np.einsum("ux,abxy,vy->abuv", m, blocks, m, optimize=True)
    q = qtbl.astype(np.float64).reshape(8, 8)
    return np.clip(np.round(dct / q), -32768, 32767).astype(
        np.int16).reshape(hb, wb, 64)


def make_image(h, w, color=False, seed=0, quality=75, sampling=(2, 2),
               kind="photo"):
    """A JpegImage of the synthetic image of ``kind``: gray, or YCbCr with
    the luma sampling factors ``sampling`` = (h, v) and 1x1 chroma: (1, 1)
    4:4:4, (2, 1) 4:2:2, (1, 2) 4:4:0, (2, 2) 4:2:0 (the default), (4, 1)
    4:1:1, (4, 2).  Chroma is box-averaged over each h x v cell, the edge
    replicated where the image does not fill the last cell."""
    pix = synth_image(h, w, seed, color, kind)
    ceil = lambda a, b: -(-a // b)
    if not color:
        qt = quality_table(STD_LUMA, quality)
        img = JpegImage(width=w, height=h, jpeg_color_space=JCS_GRAYSCALE,
                        progressive=False, max_h_samp_factor=1,
                        max_v_samp_factor=1)
        hb, wb = ceil(h, 8), ceil(w, 8)
        img.components.append(ComponentData(
            component_id=1, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=0, width_in_blocks=wb, height_in_blocks=hb,
            quantval=qt, coefs=_plane_coefs(pix, hb, wb, qt)))
        return img
    rgb = pix.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    fh, fv = sampling

    def down(c):
        c = np.pad(c, ((0, -h % fv), (0, -w % fh)), mode="edge")
        return c.reshape(c.shape[0] // fv, fv, c.shape[1] // fh, fh).mean(
            axis=(1, 3))

    img = JpegImage(width=w, height=h, jpeg_color_space=JCS_YCBCR,
                    progressive=False, max_h_samp_factor=fh,
                    max_v_samp_factor=fv)
    qy = quality_table(STD_LUMA, quality)
    qc = quality_table(STD_CHROMA, quality)
    planes = ((1, (fh, fv), qy, 0, y), (2, (1, 1), qc, 1, down(cb)),
              (3, (1, 1), qc, 1, down(cr)))
    for cid, (sh, sv), qt, tno, plane in planes:
        # libjpeg: ceil(image size * factor / (max factor * 8))
        hb, wb = ceil(h * sv, 8 * fv), ceil(w * sh, 8 * fh)
        img.components.append(ComponentData(
            component_id=cid, h_samp_factor=sh, v_samp_factor=sv,
            quant_tbl_no=tno, width_in_blocks=wb, height_in_blocks=hb,
            quantval=qt, coefs=_plane_coefs(np.round(plane), hb, wb, qt)))
    return img


def make_planes_image(h, w, ncomp=3, seed=0, quality=75, kind="photo"):
    """A JpegImage of ``ncomp`` (3: RGB, 4: CMYK) 1x1-sampled components
    that are not YCbCr, each channel of the synthetic image coded as it
    is, the first under the luma table and the others under the chroma
    table (a libjpeg file of that colour space without the transform):
    the engine smooths each as luma and runs no colour path."""
    pix = synth_image(h, w, seed, "cmyk" if ncomp == 4 else True, kind)
    img = JpegImage(width=w, height=h,
                    jpeg_color_space=JCS_CMYK if ncomp == 4 else JCS_RGB,
                    progressive=False, max_h_samp_factor=1,
                    max_v_samp_factor=1)
    hb, wb = -(-h // 8), -(-w // 8)
    tables = (quality_table(STD_LUMA, quality),
              quality_table(STD_CHROMA, quality))
    for ci in range(ncomp):
        qt = tables[min(ci, 1)]
        img.components.append(ComponentData(
            component_id=ci + 1, h_samp_factor=1, v_samp_factor=1,
            quant_tbl_no=min(ci, 1), width_in_blocks=wb, height_in_blocks=hb,
            quantval=qt.copy(), coefs=_plane_coefs(pix[..., ci], hb, wb, qt)))
    return img


DAMAGES = ("qtable", "coef", "ones")


def damage(img, kind, comp, seed=0):
    """``img`` with component ``comp`` damaged, in place (the engine's
    special inputs, quantsmooth.h:2500-2504 and 2596-2610): "qtable", one
    quantizer of at least 0x800 (a crafted file: the whole image is only
    dequantized); "coef", one coefficient whose dequantized value passes
    int16 (the dequantization guard trips); "ones", a table of all ones
    (already processed: no smoothing pass).  Where is drawn from
    ``seed``.  Returns img."""
    rng = np.random.default_rng(seed)
    c = img.components[comp]
    if kind == "qtable":
        c.quantval = c.quantval.copy()
        c.quantval[rng.integers(64)] = rng.integers(0x800, 0x10000)
    elif kind == "coef":
        q = int(c.quantval.max())
        k = int(np.argmax(c.quantval))
        v = min(32767 // q + 1 + int(rng.integers(0, 64)), 32767)
        c.coefs = c.coefs.copy()
        c.coefs[rng.integers(c.height_in_blocks), rng.integers(
            c.width_in_blocks), k] = v if rng.random() < 0.5 else -v
    elif kind == "ones":
        c.quantval = np.ones(64, np.uint16)
    else:
        raise ValueError(kind)
    return img
