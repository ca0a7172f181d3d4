"""The smoothing engine, PyTorch/CUDA port of ``jpegqs_tpu.engine``.

The equivalent of the reference's ``do_quantsmooth``
(quantsmooth.h:2404-2878) for the paths this package covers: gray and
multi-component images at every flag set that needs no chroma
downsample (q3, q4, and q5/q6 on gray or non-YCbCr images, where those
flags reduce to DIAGONALS).  Per component, on the card:

1. dequantize with int16 storage and the crafted-file guard
   (quantsmooth.h:2596-2610);
2. the pixel bootstrap, kernel ``idct_pix``;
3. ``niter`` passes of the sweep + rebalance kernel
   ``solve_rebalance_pix``, each emitting the next pass's pixels;
4. the guard's fallback to the plain dequantized coefficients and the
   +-1023 clamp (2668-2689).

Entropy decode/encode stays on the host (host/jpegio.py).  Output
planes are bit-identical to ``jpegqs_tpu.engine``.  Entry points run on
the card unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions; without a card they raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .options import (JOINT_YUV, UPSAMPLE_UV, LOW_QUALITY, NO_REBALANCE,
                      NO_REBALANCE_UV, ITER_MAX, QsOptions)
from .ops import cuda_solver
from .ops.quant import make_quant_tables

I32 = torch.int32
I16 = torch.int16


class SmoothResult:
    """Engine output: transformed (quant=1) coefficient planes."""

    def __init__(self):
        self.coefs = []        # per-component int16 [hb, wb, 64]
        self.upsampled = None  # never set on the paths of this package
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
    if opts.flags & LOW_QUALITY:
        raise NotImplementedError(
            "LOW_QUALITY (q0-q2) is not ported yet (ROADMAP A8)")
    if _need_downsample(img, opts.flags):
        raise NotImplementedError(
            "JOINT_YUV / UPSAMPLE_UV on a YCbCr colour image are not "
            "ported yet (ROADMAP A6, A7)")


def int16_wrap(x):
    """Model C's int16 coefficient storage (JCOEF) exactly."""
    return x.to(I16).to(I32)


def component_smooth(coef16, qraw, div, x1, qshr, *, hb, wb, flags, niter,
                     luma):
    """Full smoothing of one component plane on the device of its inputs
    (the port of engine._component_smooth_body without the color-path
    planes).

    coef16 int16[B, 64] (quantized, straight from entropy decode); qraw
    int32[64] raw quantizers; div/x1/qshr from make_quant_tables.
    Returns (coef int16-range int32[B, 64], badv bool scalar tensor)."""
    prod = (coef16.to(I32).T * qraw[:, None]).contiguous()   # planar [64, B]
    # the guard: OR-reduce(prod + 0x800) >> 12 != 0 (arithmetic shift)
    badv = ((prod + 0x800) >> 12).ne(0).any()
    coef = int16_wrap(prod)
    coef_dq = coef
    do_reb = not (flags & NO_REBALANCE
                  or (not luma and (flags & NO_REBALANCE_UV)))
    pix = cuda_solver.idct_pix(coef)
    for it in range(niter):
        keep = it < niter - 1
        coef, new_pix = cuda_solver.solve_rebalance_pix(
            coef, pix, div, x1, qshr, flags, do_reb, hb, wb, want_pix=keep)
        if keep:
            pix = new_pix
    # crafted-file fallback: keep the plain dequantized coefficients
    coef = torch.where(badv, coef_dq, coef)
    return torch.clamp(coef, -1023, 1023).T, badv


@dataclass
class CompPlan:
    ci: int
    hb: int
    wb: int
    niter: int
    luma: bool
    mode: str           # "smooth" or "dequant" (after a static stop)
    qraw: np.ndarray


def plan_image(img, opts: QsOptions):
    """Static plan of the whole-image run (prepare_fused without the
    downsample paths): (comp plans, static_stop), or None when nothing
    runs on the device."""
    num_iter = min(max(opts.niter, 0), ITER_MAX)
    if num_iter <= 0:
        return None
    static_stop = False
    plans = []
    for ci, comp in enumerate(img.components):
        qraw = np.asarray(comp.quantval, dtype=np.int32)
        if not qraw.any():
            continue
        niter2 = num_iter
        val = int(np.bitwise_or.reduce(qraw))
        if val <= 1:
            niter2 = 0          # already processed (quantsmooth.h:2500-2501)
        if val >= 0x800:
            static_stop = True  # crafted file (quantsmooth.h:2502-2504)
        if niter2 == 0:
            continue
        plans.append(CompPlan(
            ci=ci, hb=comp.height_in_blocks, wb=comp.width_in_blocks,
            niter=niter2, luma=(ci == 0) or not img.is_ycbcr,
            mode="dequant" if static_stop else "smooth", qraw=qraw))
    return plans, static_stop


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


def run_image(plans, inputs, flags):
    """Whole-image device run: component sequencing and on-device stop
    propagation (engine._image_smooth_impl): once a component trips the
    dequantization guard, later components come out plain-dequantized
    (unclamped).  Returns (int16[B, 64] outputs, badv tensors)."""
    device = inputs[0][0].device
    stop = torch.zeros((), dtype=torch.bool, device=device)
    outs, badvs = [], []
    for p, (coef16, qraw, div, x1, qshr) in zip(plans, inputs):
        dq16 = (coef16.to(I32) * qraw[None, :]).to(I16)
        if p.mode == "dequant":
            outs.append(dq16)
            continue
        coef, badv = component_smooth(coef16, qraw, div, x1, qshr, hb=p.hb,
                                      wb=p.wb, flags=flags, niter=p.niter,
                                      luma=p.luma)
        outs.append(torch.where(stop, dq16, coef.to(I16)))
        badvs.append(badv)
        stop = stop | badv
    return outs, badvs


def _smooth_fused(img, opts: QsOptions, device) -> SmoothResult:
    res = SmoothResult()
    res.coefs = [np.asarray(c.coefs, dtype=np.int16).copy()
                 for c in img.components]
    plan = plan_image(img, opts)
    if plan is None:
        return res
    plans, static_stop = plan
    if not plans:
        res.stop = int(static_stop)
        return res
    outs, badvs = run_image(plans, upload(img, plans, device), opts.flags)
    for p, out in zip(plans, outs):
        res.coefs[p.ci] = out.cpu().numpy().reshape(p.hb, p.wb, 64)
    res.stop = int(static_stop or any(bool(b) for b in badvs))
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
        return f.save(optimize=optimize)
