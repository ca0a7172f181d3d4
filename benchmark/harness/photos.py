"""The traffic's images: seeded synthetic JPEG coefficient images, made
in torch on the card.

A frozen copy of the program's "photo" generator (``synth.py``, the
generator of its test corpus): photo-like content (sines, a blocky
overlay, Gaussian noise), the JFIF RGB -> YCbCr transform, chroma
averaged over each sampling cell, an orthonormal 8x8 DCT in float64 and
quantization with the IJG standard tables scaled to the source quality
(jcparam.c), with the component geometry libjpeg gives the same image.
Each image of a pool shifts the pattern by an offset drawn from the seed,
so the images differ in content and not only in noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# IJG standard tables (ITU T.81 Annex K.1), natural order
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    dtype=np.int64)
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, dtype=np.int64)

# the luma's sampling factors (h, v) of each chroma subsampling a traffic
# mix may name; chroma is 1x1
SAMPLING = {"4:2:0": (2, 2)}


@dataclass
class Component:
    component_id: int
    h_samp: int
    v_samp: int
    quant_tbl_no: int
    hb: int
    wb: int
    quantval: np.ndarray    # uint16[64]
    coefs: np.ndarray       # int16[hb, wb, 64]


@dataclass
class Photo:
    width: int
    height: int
    ycbcr: bool
    comps: list

    @property
    def megapixels(self) -> float:
        return self.width * self.height / 1e6


def parse_wh(text: str):
    w, h = (int(v) for v in text.lower().split("x"))
    return w, h


def quality_table(base, quality):
    """jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)


def photo_pixels(h, w, noise, offset=(0, 0)):
    """The "photo" pattern plus ``noise`` (float64[h, w], on the device
    the image is made on) -> (gray uint8[h, w], rgb uint8[h, w, 3]); the
    pattern is shifted by ``offset`` = (dy, dx) pixels."""
    dev = noise.device
    f64 = torch.float64
    yy = (torch.arange(h, device=dev, dtype=f64) + offset[0])[:, None]
    xx = (torch.arange(w, device=dev, dtype=f64) + offset[1])[None, :]
    img = (128 + 60 * torch.sin(xx * 0.07 + torch.sin(yy * 0.05) * 3)
           + 40 * torch.cos(yy * 0.11) + 15 * torch.sin((xx + yy) * 0.21))
    img = img + noise
    mask = (yy.long() // 24 + xx.long() // 31) % 5 == 0
    img = img + 55 * mask
    u8 = lambda v: torch.clamp(v, 0, 255).to(torch.uint8)
    g = u8(img)
    r = u8(img + 30 * torch.sin(xx * 0.03))
    b = u8(img - 25 * torch.cos(yy * 0.04))
    return g, torch.stack([r, g, b], dim=-1)


def _dct_matrix(dev):
    n = torch.arange(8, dtype=torch.float64, device=dev)
    m = torch.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * 0.5
    m[0] *= np.sqrt(0.5)
    return m


def plane_coefs(plane, hb, wb, qtbl):
    """Level-shifted, edge-padded float64 plane -> quantized
    int16[hb, wb, 64] (on the plane's device)."""
    h, w = plane.shape
    p = torch.nn.functional.pad((plane - 128.0)[None, None],
                                (0, wb * 8 - w, 0, hb * 8 - h),
                                mode="replicate")[0, 0]
    blocks = p.reshape(hb, 8, wb, 8).permute(0, 2, 1, 3)
    m = _dct_matrix(plane.device)
    dct = m @ blocks @ m.T
    q = torch.from_numpy(qtbl.astype(np.float64)).to(plane.device).reshape(
        8, 8)
    return torch.clamp(torch.round(dct / q), -32768, 32767).to(
        torch.int16).reshape(hb, wb, 64)


def photo_image(pix, sampling, quality) -> Photo:
    """A YCbCr coded image of ``pix`` (rgb uint8[h, w, 3]) with the luma
    sampling factors ``sampling`` = (h, v) and 1x1 chroma, coefficients
    back on the host."""
    ceil = lambda a, b: -(-a // b)
    qy = quality_table(STD_LUMA, quality)
    h, w = pix.shape[:2]
    rgb = pix.to(torch.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    fh, fv = sampling

    def down(c):
        c = torch.nn.functional.pad(c[None, None], (0, -w % fh, 0, -h % fv),
                                    mode="replicate")[0, 0]
        return c.reshape(c.shape[0] // fv, fv, c.shape[1] // fh, fh).mean(
            dim=(1, 3))

    qc = quality_table(STD_CHROMA, quality)
    comps = []
    for cid, (sh, sv), qt, tno, plane in (
            (1, (fh, fv), qy, 0, y), (2, (1, 1), qc, 1, down(cb)),
            (3, (1, 1), qc, 1, down(cr))):
        # libjpeg: ceil(image size * factor / (max factor * 8))
        hb, wb = ceil(h * sv, 8 * fv), ceil(w * sh, 8 * fh)
        coefs = plane_coefs(torch.round(plane), hb, wb, qt)
        comps.append(Component(cid, sh, sv, tno, hb, wb, qt,
                               coefs.cpu().numpy()))
    return Photo(w, h, True, comps)


def make_pool(traffic: dict, seed: int, device) -> list:
    """The pool of ``pool_images`` distinct photos of the traffic mix,
    from ``seed``: per image an offset of the pattern and a noise seed."""
    w, h = parse_wh(traffic["image_wh"])
    sampling = SAMPLING[traffic["sampling"]]
    rng = np.random.default_rng([seed, 0])
    pool = []
    for _ in range(traffic["pool_images"]):
        dy, dx = (int(v) for v in rng.integers(0, 4096, 2))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(0, 2 ** 62)))
        noise = torch.randn((h, w), generator=gen, dtype=torch.float64,
                            device=device) * 4
        _, rgb = photo_pixels(h, w, noise, (dy, dx))
        pool.append(photo_image(rgb, sampling, traffic["source_quality"]))
    return pool
