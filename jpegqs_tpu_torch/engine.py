"""The smoothing engine, PyTorch/CUDA port of ``jpegqs_tpu.engine``.

The equivalent of the reference's ``do_quantsmooth``
(quantsmooth.h:2404-2878) at every quality level, q0-q6, on gray and
YCbCr colour at any sampling factors.  Per component, on the card:

1. dequantize with int16 storage and the crafted-file guard
   (quantsmooth.h:2596-2610);
2. the pixel bootstrap, kernel ``idct_pix`` (B1);
3. ``niter`` passes, each emitting the next pass's pixels: the sweep +
   rebalance kernel ``solve_rebalance_pix`` (B2), or the fused kernel
   ``solve_fused_pix`` with the JOINT_YUV preamble (B3, chroma at q1, q2,
   q5, q6) or the LOW_QUALITY one (B4, every other component at q0-q2);
4. the guard's fallback to the plain dequantized coefficients and the
   +-1023 clamp (2668-2689).

Between the components, the colour paths run as eager torch glue on the
card (the JAX package runs them as XLA ops): after the luma, the
downsampled luma halos that JOINT_YUV reads (image2) and, for
UPSAMPLE_UV, the luma pixels (image1); after each chroma component its
upsampled luma-size coefficients.  Sampling factors up to 2 stay in
block form; larger ones (4:1:1, 4x2) go through padded planes.

Entropy decode/encode stays on the host (host/jpegio.py).  Output
planes, upsampled planes and the stop flag are bit-identical to
``jpegqs_tpu.engine``.  Entry points run on the card unless the caller
passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions; without a card they raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .options import (JOINT_YUV, UPSAMPLE_UV, LOW_QUALITY, NO_REBALANCE,
                      NO_REBALANCE_UV, ITER_MAX, QsOptions)
from .ops import cuda_solver, planar
from .ops.dct import fdct_float
from .ops.plane import downsample_plane
from .ops.quant import make_quant_tables, roundf, c_f32_to_i32
from .ops.upsample import upsample_chroma

I32 = torch.int32
I16 = torch.int16
F32 = torch.float32
CENTERJSAMPLE = 128


class SmoothResult:
    """Engine output: transformed (quant=1) coefficient planes."""

    def __init__(self):
        self.coefs = []        # per-component int16 [hb, wb, 64]
        self.upsampled = None  # (cb, cr) int16 at luma dims, or None
        self.stop = 0


def resolve_device(device=None) -> torch.device:
    """The card by default; the CPU only when asked for.  Raises when a
    card is wanted and there is none -- never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: jpegqs_tpu_torch runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _need_downsample(img, flags) -> bool:
    comps = img.components
    return (bool(flags & (JOINT_YUV | UPSAMPLE_UV)) and img.is_ycbcr
            and len(comps) >= 3
            and comps[1].h_samp_factor == 1 and comps[1].v_samp_factor == 1
            and comps[2].h_samp_factor == 1 and comps[2].v_samp_factor == 1)


def check_supported(img, opts: QsOptions) -> None:
    """Raise NotImplementedError for the paths not ported yet."""
    if opts.progress is not None:
        raise NotImplementedError(
            "progress callbacks are not ported yet (ROADMAP A10)")


def int16_wrap(x):
    """Model C's int16 coefficient storage (JCOEF) exactly."""
    return x.to(I16).to(I32)


def component_smooth(coef16, qraw, div, x1, qshr, image2=None, *, hb, wb,
                     flags, niter, luma, extra_refresh=0):
    """Full smoothing of one component plane on the device of its inputs
    (the port of engine._component_smooth_body).

    coef16 int16[B, 64] (quantized, straight from entropy decode); qraw
    int32[64] raw quantizers; div/x1/qshr from make_quant_tables; image2
    int32[100, B] the downsampled-luma halos when the JOINT_YUV preamble
    runs, else None.  ``extra_refresh``: the last pass also emits its
    pixels (a colour path reads them).  Returns (coef int16-range
    int32[B, 64], pixels int32[64, B] of the final coefficients before
    the fallback and clamp -- or None without extra_refresh --, badv
    bool scalar tensor)."""
    prod = (coef16.to(I32).T * qraw[:, None]).contiguous()   # planar [64, B]
    # the guard: OR-reduce(prod + 0x800) >> 12 != 0 (arithmetic shift)
    badv = ((prod + 0x800) >> 12).ne(0).any()
    coef = int16_wrap(prod)
    coef_dq = coef
    do_reb = not (flags & NO_REBALANCE
                  or (not luma and (flags & NO_REBALANCE_UV)))
    fused = image2 is not None or bool(flags & LOW_QUALITY)
    pix = cuda_solver.idct_pix(coef)
    for it in range(niter):
        keep = it < niter - 1 or bool(extra_refresh)
        if fused:
            coef, new_pix = cuda_solver.solve_fused_pix(
                coef, pix, image2, div, x1, qshr, flags, do_reb, hb, wb,
                want_pix=keep)
        else:
            coef, new_pix = cuda_solver.solve_rebalance_pix(
                coef, pix, div, x1, qshr, flags, do_reb, hb, wb,
                want_pix=keep)
        if keep:
            pix = new_pix
    # crafted-file fallback: keep the plain dequantized coefficients
    coef = torch.where(badv, coef_dq, coef)
    return (torch.clamp(coef, -1023, 1023).T,
            pix if extra_refresh else None, badv)


@dataclass
class CompPlan:
    ci: int
    hb: int
    wb: int
    niter: int
    extra_refresh: int  # the colour paths read this component's pixels
    luma: bool
    mode: str           # "smooth" or "dequant" (after a static stop)
    qraw: np.ndarray


@dataclass
class ImagePlan:
    flags: int
    comps: list         # CompPlan of each component that runs
    static_stop: bool
    need_downsample: bool   # the luma feeds image2 (and maybe image1)
    image1_live: bool       # UPSAMPLE_UV output will exist
    ds_blocks: bool         # sampling factors <= 2: block-form colour path
    img_w: int
    img_h: int
    ws: int
    hs: int


def plan_image(img, opts: QsOptions):
    """Static plan of the whole-image run (engine.prepare_fused), or None
    when nothing runs on the device."""
    comps = img.components
    flags = opts.flags
    need_downsample = _need_downsample(img, flags)
    num_iter = min(max(opts.niter, 0), ITER_MAX)
    if num_iter <= 0 and not ((flags & UPSAMPLE_UV) and need_downsample):
        return None
    ws, hs = comps[0].h_samp_factor, comps[0].v_samp_factor
    static_stop = image1_live = downsample_live = False
    plans = []
    for ci, comp in enumerate(comps):
        qraw = np.asarray(comp.quantval, dtype=np.int32)
        if not qraw.any():
            continue            # no quant table came with this component
        extra_refresh = int(image1_live or (ci == 0 and need_downsample))
        niter2 = num_iter
        val = int(np.bitwise_or.reduce(qraw))
        if val <= 1:
            niter2 = 0          # already processed (quantsmooth.h:2500-2501)
        if val >= 0x800:
            static_stop = True  # crafted file (quantsmooth.h:2502-2504)
        if niter2 + extra_refresh == 0:
            continue            # (quantsmooth.h:2542)
        mode = "dequant" if static_stop else "smooth"
        plans.append(CompPlan(
            ci=ci, hb=comp.height_in_blocks, wb=comp.width_in_blocks,
            niter=niter2, extra_refresh=extra_refresh,
            luma=(ci == 0) or not img.is_ycbcr, mode=mode, qraw=qraw))
        if mode == "smooth" and ci == 0 and need_downsample:
            if not (ws == 1 and hs == 1) and (flags & UPSAMPLE_UV):
                image1_live = True
            downsample_live = True
    return ImagePlan(flags=flags, comps=plans, static_stop=static_stop,
                     need_downsample=downsample_live,
                     image1_live=image1_live,
                     ds_blocks=downsample_live and ws <= 2 and hs <= 2,
                     img_w=img.width, img_h=img.height, ws=ws, hs=hs)


def upload(img, plans, device):
    """Device inputs per planned component: (coef16, qraw, div, x1,
    qshr).  Kept apart from the run so callers can time device work."""
    inputs = []
    for p in plans:
        comp = img.components[p.ci]
        coef16 = np.ascontiguousarray(comp.coefs, np.int16).reshape(
            p.hb * p.wb, 64)
        tabs = (p.qraw, *make_quant_tables(p.qraw))
        inputs.append((torch.from_numpy(coef16).to(device),
                       *(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                         for t in tabs)))
    return inputs


def fdct_round_i16(fblocks, hb, wb):
    """Luma-size coefficients of upsampled chroma: float FDCT of the
    centred blocks f32[8, 8, B], roundf, C cast, int16 [hb, wb, 64]
    (reference: quantsmooth.h:2732-2750)."""
    c = c_f32_to_i32(roundf(fdct_float(fblocks).reshape(64, hb * wb)))
    # contiguous on the device: the host copy is then one plain memcpy
    return c.to(I16).T.contiguous().reshape(hb, wb, 64)


def _upsample_fdct(pix, image2, image1, plan: ImagePlan):
    """UPSAMPLE_UV of one chroma component: its final pixels, the
    downsampled luma (image2) and the luma pixels (image1) -> int16
    [hb_l, wb_l, 64] (engine._image_smooth_impl's image1 branch)."""
    hbl, wbl = plan.comps[0].hb, plan.comps[0].wb
    hbc, wbc = plan.comps[1].hb, plan.comps[1].wb
    if plan.ds_blocks:
        up = planar.upsample_chroma_blocks(
            planar.blocks_halo10(pix.reshape(8, 8, -1), hbc, wbc),
            image2.reshape(10, 10, -1), image1.reshape(8, 8, -1),
            plan.img_w, plan.img_h, plan.ws, plan.hs, hbl, wbl, hbc, wbc)
        return fdct_round_i16((up - CENTERJSAMPLE).to(F32), hbl, wbl)
    mem = upsample_chroma(planar.pix_to_plane(pix, hbc, wbc), image2, image1,
                          plan.img_w, plan.img_h, plan.ws, plan.hs, hbl, wbl)
    fb = planar.plane_to_fblocks_p((mem - CENTERJSAMPLE).to(F32), hbl, wbl)
    return fdct_round_i16(fb, hbl, wbl)


def _luma_products(pix, plan: ImagePlan):
    """After the luma: (image1, image2, image2 halos [100, Bc]) for the
    colour paths (engine._image_smooth_impl's need_downsample branch).
    image2 is the downsampled luma as halos in block form, as a padded
    plane in plane form; image1 the luma pixels (blocks or plane) when
    UPSAMPLE_UV needs them, else None."""
    hbl, wbl = plan.comps[0].hb, plan.comps[0].wb
    hbc, wbc = plan.comps[1].hb, plan.comps[1].wb
    if plan.ds_blocks:
        ds = planar.downsample_blocks(pix.reshape(8, 8, -1), hbl, wbl, hbc,
                                      wbc, plan.ws, plan.hs)
        halo = planar.blocks_halo10(ds, hbc, wbc).reshape(100, -1)
        return (pix if plan.image1_live else None), halo, halo
    luma = planar.pix_to_plane(pix, hbl, wbl)
    image2 = downsample_plane(luma, hbl, wbl, hbc, wbc, plan.ws, plan.hs)
    halo = planar.padded_plane_to_halo10(image2, hbc, wbc).reshape(100, -1)
    return (luma if plan.image1_live else None), image2, halo


def run_image(plan: ImagePlan, inputs):
    """Whole-image device run (engine._image_smooth_impl): component
    sequencing, the colour paths and on-device stop propagation -- once
    a component trips the dequantization guard, later components come
    out plain-dequantized (unclamped).  Returns (int16[B, 64] outputs,
    badv tensors, {component index: upsampled int16[hb_l, wb_l, 64]})."""
    device = inputs[0][0].device
    flags = plan.flags
    stop = torch.zeros((), dtype=torch.bool, device=device)
    image1 = image2 = image2_halo = None
    outs, badvs, ups = [], [], {}
    for k, (p, (coef16, qraw, div, x1, qshr)) in enumerate(
            zip(plan.comps, inputs)):
        dq16 = (coef16.to(I32) * qraw[None, :]).to(I16)
        if p.mode == "dequant":
            outs.append(dq16)
            continue
        joint = image2 is not None and bool(flags & JOINT_YUV)
        coef, pix, badv = component_smooth(
            coef16, qraw, div, x1, qshr, image2_halo if joint else None,
            hb=p.hb, wb=p.wb, flags=flags, niter=p.niter, luma=p.luma,
            extra_refresh=p.extra_refresh)
        outs.append(torch.where(stop, dq16, coef.to(I16)))
        badvs.append(badv)
        stop = stop | badv
        if image1 is not None:
            ups[p.ci] = _upsample_fdct(pix, image2, image1, plan)
        elif k == 0 and plan.need_downsample and len(plan.comps) > 1:
            # (len guard: at 4:4:4 + UPSAMPLE_UV + niter 0 the chroma
            # components drop out entirely, quantsmooth.h:2542, leaving
            # nothing to read the downsampled luma)
            image1, image2, image2_halo = _luma_products(pix, plan)
    return outs, badvs, ups


def _smooth_fused(img, opts: QsOptions, device) -> SmoothResult:
    res = SmoothResult()
    res.coefs = [np.asarray(c.coefs, dtype=np.int16).copy()
                 for c in img.components]
    plan = plan_image(img, opts)
    if plan is None:
        return res
    if not plan.comps:
        res.stop = int(plan.static_stop)
        return res
    outs, badvs, ups = run_image(plan, upload(img, plan.comps, device))
    for p, out in zip(plan.comps, outs):
        res.coefs[p.ci] = out.cpu().numpy().reshape(p.hb, p.wb, 64)
    res.stop = int(plan.static_stop or any(bool(b) for b in badvs))
    if not res.stop and 1 in ups and 2 in ups:
        res.upsampled = (ups[1].cpu().numpy(), ups[2].cpu().numpy())
    return res


def smooth(img, opts: QsOptions, device=None) -> SmoothResult:
    """Run the engine on a decoded-to-coefficients JPEG
    (host.jpegio.JpegImage), on the card unless ``device="cpu"``.

    A device allocation failure degrades to plain host-side
    dequantization, like the reference's malloc-failure path."""
    check_supported(img, opts)
    dev = resolve_device(device)
    try:
        return _smooth_fused(img, opts, dev)
    except torch.cuda.OutOfMemoryError:
        return _smooth_degraded(img, opts)


def _smooth_degraded(img, opts: QsOptions) -> SmoothResult:
    """Allocation-failure degradation: plain host-side dequantization
    (reference: quantsmooth.h:2551-2566 -- when the scratch plane fails
    to allocate, each component's coefficients are multiplied by the
    quant table in place, int16 storage wrap, unclamped, and processing
    keeps going).  No device work at all."""
    res = SmoothResult()
    comps = img.components
    res.coefs = [np.asarray(c.coefs, np.int16).copy() for c in comps]
    num_iter = min(max(opts.niter, 0), ITER_MAX)
    if num_iter <= 0 and not (opts.flags & UPSAMPLE_UV):
        return res
    for ci, comp in enumerate(comps):
        qraw = np.asarray(comp.quantval, np.int32)
        if not qraw.any():
            continue
        val = int(np.bitwise_or.reduce(qraw))
        if val >= 0x800:
            res.stop = 1          # crafted file (quantsmooth.h:2502-2504)
        if val <= 1:
            continue              # already processed (2500-2501)
        hb, wb = comp.height_in_blocks, comp.width_in_blocks
        c = res.coefs[ci].reshape(hb * wb, 64).astype(np.int32)
        res.coefs[ci] = (c * qraw[None, :]).astype(np.int16).reshape(
            hb, wb, 64)
    return res


def _save_result(data: bytes, res: SmoothResult,
                 optimize: bool = False) -> bytes:
    """Re-encode a SmoothResult into the original container (the
    transcode tail of quantsmooth.c:552-593)."""
    from .host.jpegio import JpegCoefFile

    with JpegCoefFile(data) as f:
        img = f.read()
        for ci in range(len(img.components)):
            f.write_coefs(ci, res.coefs[ci])
        if res.upsampled is not None:
            f.set_upsampled(res.upsampled[0], res.upsampled[1])
        return f.save(optimize=optimize)


def smooth_jpeg_bytes(data: bytes, opts: QsOptions = None,
                      optimize: bool = False, device=None) -> bytes:
    """Transcode: JPEG bytes in, smoothed JPEG bytes out with all quant
    tables set to 1 (the reference CLI's flow, quantsmooth.c:494-623)."""
    from .host.jpegio import JpegCoefFile

    if opts is None:
        opts = QsOptions.from_quality(3, 3)
    with JpegCoefFile(data) as f:
        img = f.read()
        res = smooth(img, opts, device)
        for ci in range(len(img.components)):
            f.write_coefs(ci, res.coefs[ci])
        if res.upsampled is not None:
            f.set_upsampled(res.upsampled[0], res.upsampled[1])
        return f.save(optimize=optimize)
