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
block form, where the upsample with its FDCT is one kernel,
``upsample_fdct_blocks``; larger ones (4:1:1, 4x2) go through padded
planes.

With a progress callback (``opts.progress``) the engine runs the
reference's progress path instead (_smooth_percomp): per component and
per iteration the IDCT (B1), the pass's neighbourhood materialised from
the whole plane, and one pass on it -- B5 ``solve_rebalance`` or B6
``solve_fused`` -- or, with ``opts.precise``, one pass per row chunk,
so the callback fires (and may cancel) at the reference's points.  Its
colour paths always use padded planes.  Both paths give the same
output when the callback never cancels.

On a machine with more than one CUDA device, ``smooth`` without a
callback shards large images over every device (parallel/sharded.py, the
JAX package's auto-sharding): _shard_grid picks the grid -- block rows
first, and block columns too when an image has fewer block rows than
devices -- and _try_smooth_sharded runs the gray/per-component or the
YCbCr flow, or declines where the JAX engine does.  Each shard's pass is
kernel B7 over its real blocks between exchanges of the ghost pixel
lines.

Entropy decode/encode stays on the host (host/jpegio.py).  Output
planes, upsampled planes and the stop flag are bit-identical to
``jpegqs_tpu.engine``.  ``decode_smoothed`` decodes the smoothed planes to
pixels on the device (ops/colorout.py: B1 and exact int32 glue); the
batch engine (batch.py) runs ``run_image`` over many images at once.
Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions; without a card they
raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .options import (JOINT_YUV, UPSAMPLE_UV, LOW_QUALITY, NO_REBALANCE,
                      NO_REBALANCE_UV, ITER_MAX, QsOptions)
from .ops import cuda_solver, planar
from .ops._build import KernelError
from .ops.plane import downsample_plane
from .ops.quant import make_quant_tables
from .ops.upsample import upsample_chroma

I32 = torch.int32
I16 = torch.int16
F32 = torch.float32


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


def int16_wrap(x):
    """Model C's int16 coefficient storage (JCOEF) exactly."""
    return x.to(I16).to(I32)


def dequant(coef16, qraw, n=1):
    """Iter-0 dequantization with the crafted-file guard
    (quantsmooth.h:2596-2610; engine._dequant_stage): coef16 int16[B, 64],
    n images back to back -> (planar int16-wrapped int32[64, B], badv
    bool[n], the guard of each image)."""
    prod = (coef16.to(I32).T * qraw[:, None]).contiguous()   # planar [64, B]
    # the guard: OR-reduce(prod + 0x800) >> 12 != 0 (arithmetic shift)
    badv = ((prod + 0x800) >> 12).ne(0).reshape(64, n, -1).any(2).any(0)
    return int16_wrap(prod), badv


def dequant_only(coef16, qraw):
    """The dequantize-only fallback once a crafted file has set stop
    (quantsmooth.h:2551-2566): int16[B, 64], wrapped, unclamped."""
    return (coef16.to(I32) * qraw[None, :]).to(I16)


def _do_rebalance(flags, luma) -> bool:
    return not (flags & NO_REBALANCE
                or (not luma and (flags & NO_REBALANCE_UV)))


def component_smooth(coef16, qraw, div, x1, qshr, image2=None, *, hb, wb,
                     flags, niter, luma, extra_refresh=0, n=1):
    """Full smoothing of one component plane, or of the same component of
    ``n`` same-shape images back to back on the block axis, on the device
    of its inputs (the port of engine._component_smooth_body and of
    batch._batch_component).

    coef16 int16[B, 64] (quantized, straight from entropy decode; B = n *
    hb * wb); qraw int32[64] raw quantizers; div/x1/qshr from
    make_quant_tables; image2 int32[100, B] the downsampled-luma halos
    when the JOINT_YUV preamble runs, else None.  ``extra_refresh``: the
    last pass also emits its pixels (a colour path reads them).  The
    kernels take each image's edges from ``b % (hb * wb)``, so an image's
    result does not depend on its neighbours on the axis.  Returns (coef
    int16-range int32[B, 64], pixels int32[64, B] of the final
    coefficients before the fallback and clamp -- or None without
    extra_refresh --, badv bool[n], each image's guard)."""
    coef, badv = dequant(coef16, qraw, n)
    coef_dq = coef
    do_reb = _do_rebalance(flags, luma)
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
    # crafted-file fallback, per image: keep the plain dequantized
    # coefficients
    coef = torch.where(badv[None, :, None], coef_dq.reshape(64, n, -1),
                       coef.reshape(64, n, -1)).reshape(64, -1)
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


def stack_to(arrays, dev):
    """Host arrays of one shape but the first axis, stacked on that axis,
    on ``dev`` without waiting for the card.  On a CUDA device they are
    copied into one pinned staging buffer, which the caching host
    allocator hands out again from call to call, and the buffer goes over
    in one asynchronous copy: a blocking copy would wait for the work
    already queued, and a fresh host stack costs a page fault every 4 KB
    (tools/time_batch_host.py; PERF.md)."""
    if dev.type != "cuda":
        return torch.from_numpy(np.concatenate(arrays))
    first = torch.from_numpy(np.ascontiguousarray(arrays[0]))
    host = torch.empty((sum(len(a) for a in arrays),) + first.shape[1:],
                       dtype=first.dtype, pin_memory=True)
    row = 0
    for a in arrays:
        host[row:row + len(a)] = torch.from_numpy(np.ascontiguousarray(a))
        row += len(a)
    return host.to(dev, non_blocking=True)


def upload(imgs, plans, device):
    """Device inputs per planned component of images of one plan:
    (coef16 int16[n*B, 64], each image's coefficients back to back on the
    block axis, qraw, div, x1, qshr).  Kept apart from the run so callers
    can time device work."""
    inputs = []
    for p in plans:
        coef16 = stack_to([np.asarray(im.components[p.ci].coefs,
                                      np.int16).reshape(p.hb * p.wb, 64)
                           for im in imgs], device)
        tabs = (p.qraw, *make_quant_tables(p.qraw))
        inputs.append((coef16, *(stack_to([t], device) for t in tabs)))
    return inputs


def download(tensors):
    """Queue host copies of tensors on one device; returns ``fetch() ->
    [numpy arrays]``.  From a CUDA device the copies go into pinned
    staging buffers behind the work queued so far, and an event marks
    their end: ``fetch()`` waits for that event alone, not for work
    queued after this call, then makes one host copy of each (the staging
    buffers go back to the caching host allocator).  Pinned staging is
    faster than a pageable copy (tools/time_batch_host.py; PERF.md)."""
    if not tensors or tensors[0].device.type != "cuda":
        return lambda: [t.numpy() for t in tensors]
    dev = tensors[0].device
    staged = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in tensors]
    for h, t in zip(staged, tensors):
        # contiguous on the card first: with the plane batch's transposed
        # output the download took 2.4x as long end to end (PERF.md)
        h.copy_(t.contiguous(), non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def fetch():
        done.synchronize()
        return [torch.empty(h.shape, dtype=h.dtype).copy_(h).numpy()
                for h in staged]
    return fetch


def _upsample_fdct(pix, image2, image1, plan: ImagePlan, n=1):
    """UPSAMPLE_UV of one chroma component of n images: its final pixels,
    the downsampled luma (image2) and the luma pixels (image1) -> int16
    [n, hb_l, wb_l, 64] (engine._image_smooth_impl's image1 branch; the
    vmapped one of batch._image_batch_impl).  In block form one kernel
    (cuda_solver.upsample_fdct_blocks) after the chroma halos; the plane
    form (sampling factors above 2) takes one image."""
    hbl, wbl = plan.comps[0].hb, plan.comps[0].wb
    hbc, wbc = plan.comps[1].hb, plan.comps[1].wb
    if plan.ds_blocks:
        return cuda_solver.upsample_fdct_blocks(
            planar.blocks_halo10(pix.reshape(8, 8, -1), hbc,
                                 wbc).reshape(100, -1),
            image2, image1, plan.img_w, plan.img_h, plan.ws, plan.hs, hbl,
            wbl, hbc, wbc).reshape(n, hbl, wbl, 64)
    assert n == 1, "the plane form takes one image"
    return upsample_fdct_plane(planar.pix_to_plane(pix, hbc, wbc), image2,
                               image1, plan.img_w, plan.img_h, plan.ws,
                               plan.hs, hbl, wbl)[None]


def upsample_fdct_plane(padded_chroma, image2, image1, img_w, img_h, ws, hs,
                        hb_l, wb_l):
    """UPSAMPLE_UV in plane form: the chroma component's padded pixel
    plane, the downsampled luma plane (image2) and the luma plane
    (image1) -> luma-size coefficients int16[hb_l, wb_l, 64]
    (engine._upsample_fdct_body; reference: quantsmooth.h:2732-2750)."""
    mem = upsample_chroma(padded_chroma, image2, image1, img_w, img_h, ws,
                          hs, hb_l, wb_l)
    fb = planar.plane_to_fblocks_p((mem - planar.CENTERJSAMPLE).to(F32),
                                   hb_l, wb_l)
    return planar.fdct_round_i16(fb, hb_l, wb_l)


def _luma_products(pix, plan: ImagePlan):
    """After the luma: (image1, image2, image2 halos [100, n*Bc]) for the
    colour paths (engine._image_smooth_impl's need_downsample branch).
    image2 is the downsampled luma as halos in block form, as a padded
    plane in plane form; image1 the luma pixels (blocks or plane) when
    UPSAMPLE_UV needs them, else None.  In block form pix may hold n
    images back to back; the plane form takes one."""
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


def run_image(plan: ImagePlan, inputs, n=1):
    """Whole-image device run (engine._image_smooth_impl), of one image
    or of ``n`` images of the same plan back to back on each component's
    block axis (batch._image_batch_impl): component sequencing, the
    colour paths and on-device stop propagation, per image -- once a
    component trips an image's dequantization guard, that image's later
    components come out plain-dequantized (unclamped).  inputs: per
    planned component (coef16 int16[n*B, 64], qraw, div, x1, qshr), as
    ``upload`` makes them.  Every launch is queued on the current stream
    and nothing waits for the card; the count of launches does not
    depend on n.  Returns (int16[n*B, 64] outputs, badv bool[n] tensors,
    {component index: upsampled int16[n, hb_l, wb_l, 64]})."""
    device = inputs[0][0].device
    flags = plan.flags
    stop = torch.zeros((n,), dtype=torch.bool, device=device)
    image1 = image2 = image2_halo = None
    outs, badvs, ups = [], [], {}
    for k, (p, (coef16, qraw, div, x1, qshr)) in enumerate(
            zip(plan.comps, inputs)):
        dq16 = dequant_only(coef16, qraw)
        if p.mode == "dequant":
            outs.append(dq16)
            continue
        joint = image2 is not None and bool(flags & JOINT_YUV)
        coef, pix, badv = component_smooth(
            coef16, qraw, div, x1, qshr, image2_halo if joint else None,
            hb=p.hb, wb=p.wb, flags=flags, niter=p.niter, luma=p.luma,
            extra_refresh=p.extra_refresh, n=n)
        outs.append(torch.where(stop[:, None, None], dq16.reshape(n, -1, 64),
                                coef.to(I16).reshape(n, -1, 64)).reshape(
                                    -1, 64))
        badvs.append(badv)
        stop = stop | badv
        if image1 is not None:
            ups[p.ci] = _upsample_fdct(pix, image2, image1, plan, n)
        elif k == 0 and plan.need_downsample and len(plan.comps) > 1:
            # (len guard: at 4:4:4 + UPSAMPLE_UV + niter 0 the chroma
            # components drop out entirely, quantsmooth.h:2542, leaving
            # nothing to read the downsampled luma)
            image1, image2, image2_halo = _luma_products(pix, plan)
    return outs, badvs, ups


def dispatch(imgs, plan: ImagePlan, device):
    """Queue the whole-image run of images of one plan (``run_image`` with
    n = len(imgs); the plane form takes one image) and the copies of its
    results to the host.  Nothing here waits for the card, so a caller
    can queue more work while this run computes.  Returns ``assemble() ->
    [SmoothResult]``, which waits for this run's copies alone: components
    outside the plan keep their input coefficients, an image stops on the
    plan's static stop or its own guard, and its upsampled planes are set
    only where it did not stop."""
    n = len(imgs)
    fetch, n_up, n_bad = (lambda: []), 0, 0
    if plan.comps:
        outs, badvs, ups = run_image(plan, upload(imgs, plan.comps, device),
                                     n)
        up = [ups[1], ups[2]] if 1 in ups and 2 in ups else []
        bad = [torch.stack(badvs).any(0)] if badvs else []
        n_up, n_bad = len(up), len(bad)
        fetch = download(outs + up + bad)

    def assemble():
        host = fetch()
        planned = {p.ci: o for p, o in zip(plan.comps, host)}
        up = host[len(plan.comps):len(plan.comps) + n_up]
        bad = host[-1] if n_bad else np.zeros(n, bool)
        results = []
        for i, im in enumerate(imgs):
            res = SmoothResult()
            res.coefs = [
                planned[ci].reshape(n, c.height_in_blocks,
                                    c.width_in_blocks, 64)[i]
                if ci in planned else np.asarray(c.coefs, np.int16).copy()
                for ci, c in enumerate(im.components)]
            res.stop = int(plan.static_stop or bool(bad[i]))
            if not res.stop and up:
                res.upsampled = (up[0][i], up[1][i])
            results.append(res)
        return results

    return assemble


def _smooth_fused(img, opts: QsOptions, device) -> SmoothResult:
    plan = plan_image(img, opts)
    if plan is None:
        res = SmoothResult()
        res.coefs = [np.asarray(c.coefs, dtype=np.int16).copy()
                     for c in img.components]
        return res
    return dispatch([img], plan, device)()[0]


# ---------------------------------------------------------------------------
# The progress-callback path: one device pass per iteration, or per row
# chunk under ``precise`` (engine._smooth_percomp and its stages)
# ---------------------------------------------------------------------------

def neighbourhood(pix, image2, flags, hb, wb):
    """The cross-block pixel neighbourhood of one pass, materialised
    from the whole pre-iteration plane pix int32[64, B]: the 10x10
    halos int32[100, B] when the pass is fused (image2 given or
    LOW_QUALITY), else the border lines int32[32, B]."""
    if image2 is not None or flags & LOW_QUALITY:
        return planar.blocks_halo10(pix.reshape(8, 8, -1), hb,
                                    wb).reshape(100, -1)
    return torch.cat(planar.borders_from_blocks(pix.reshape(8, 8, -1), hb,
                                                wb))


def block_pass(coef, nbhd, image2, div, x1, qshr, flags, luma, wb,
               rows=None):
    """One smoothing pass over a component (engine.block_pass_p and
    _block_pass_p): B6 when ``image2`` is given or under LOW_QUALITY,
    else B5.  coef int32[64, B] the pre-pass coefficients; nbhd from
    ``neighbourhood``; image2 int32[100, B] downsampled-luma halos or
    None.  ``rows=(r0, n)`` restricts the pass to block rows [r0, r0+n)
    (engine._rows_stage_impl): the coefficients, neighbourhood and image2
    are sliced to them.  Returns the new coefficients of those rows
    (of every block without ``rows``), int32[64, n * wb]."""
    if rows is not None:
        s = slice(rows[0] * wb, (rows[0] + rows[1]) * wb)
        coef, nbhd = coef[:, s], nbhd[:, s]
        image2 = None if image2 is None else image2[:, s]
    do_reb = _do_rebalance(flags, luma)
    if image2 is not None or flags & LOW_QUALITY:
        out, _ = cuda_solver.solve_fused(coef, nbhd, image2, div, x1, qshr,
                                         flags, do_reb)
    else:
        out, _ = cuda_solver.solve_rebalance(coef, nbhd, div, x1, qshr,
                                             flags, do_reb)
    return out


def _smooth_percomp(img, opts: QsOptions, device) -> SmoothResult:
    """Progress-callback path (engine._smooth_percomp): one device pass
    per iteration, with the reference's exact progress accounting
    (quantsmooth.h:2474-2482 init, 2652-2663 per-iteration update;
    ``progprec`` from libjpegqs.h:42-44: 0 -> 20 steps, < 0 -> the
    finest resolution) and, with ``opts.precise``, the row chunks of a
    -DPRECISE_PROGRESS build (2632-2665).  A truthy callback return
    cancels: the component keeps what its completed iterations or row
    chunks wrote, stop is set, later components are only dequantized
    and no upsampled planes come out.  The colour paths always run in
    plane form here."""
    res = SmoothResult()
    comps = img.components
    res.coefs = [np.asarray(c.coefs, dtype=np.int16).copy() for c in comps]
    flags = opts.flags
    need_downsample = _need_downsample(img, flags)
    num_iter = min(max(opts.niter, 0), ITER_MAX)
    if num_iter <= 0 and not ((flags & UPSAMPLE_UV) and need_downsample):
        return res

    stop = 0
    image1 = None   # luma padded plane (UPSAMPLE_UV)
    image2 = None   # downsampled luma padded plane (JOINT_YUV)
    image2_halo = None
    up_planes = {}

    # progress accounting: prog_next carries every component's full
    # share, including a skipped component's (no table, val <= 1), as
    # the reference advances it at the top of every component
    # (quantsmooth.h:2487-2492)
    prog_cur = 0
    prog_next = 0
    prog_max = sum(c.height_in_blocks * c.v_samp_factor * num_iter
                   for c in comps)
    prog_prec = opts.progprec
    if prog_prec == 0:
        prog_prec = 20
    if prog_prec < 0:
        prog_prec = prog_max
    prog_thr = (prog_max + prog_prec - 1) // prog_prec if prog_max else 0

    def report_progress():
        """Threshold-gated callback (quantsmooth.h:2652-2663); a truthy
        return cancels."""
        nonlocal prog_thr
        if prog_cur < prog_thr:
            return False
        cur = prog_prec * prog_cur // prog_max
        prog_thr = ((cur + 1) * prog_max + prog_prec - 1) // prog_prec
        return bool(opts.progress(opts.userdata, cur, prog_prec))

    for ci, comp in enumerate(comps):
        prog_cur = prog_next
        prog_next += comp.height_in_blocks * comp.v_samp_factor * num_iter
        qraw = np.asarray(comp.quantval, dtype=np.int32)
        if not qraw.any():
            continue            # no quant table came with this component
        hb, wb = comp.height_in_blocks, comp.width_in_blocks
        extra_refresh = int(image1 is not None
                            or (ci == 0 and need_downsample))
        num_iter2 = num_iter
        val = int(np.bitwise_or.reduce(qraw))
        if val <= 1:
            num_iter2 = 0       # already processed (quantsmooth.h:2500-2501)
        if val >= 0x800:
            stop = 1            # crafted file (quantsmooth.h:2502-2504)
        if num_iter2 + extra_refresh == 0:
            continue
        coef16 = torch.from_numpy(res.coefs[ci].reshape(hb * wb, 64)).to(
            device)
        qraw_t = torch.from_numpy(qraw).to(device)
        if stop:
            res.coefs[ci] = dequant_only(coef16, qraw_t).cpu().numpy(
            ).reshape(hb, wb, 64)
            continue

        div, x1, qshr = (torch.from_numpy(a).to(device)
                         for a in make_quant_tables(qraw))
        luma = ci == 0 or not img.is_ycbcr
        use_image2 = image2 is not None and bool(flags & JOINT_YUV)
        if use_image2 and image2_halo is None:
            image2_halo = planar.padded_plane_to_halo10(
                image2, hb, wb).reshape(100, -1)
        img2 = image2_halo if use_image2 else None
        want_plane = image1 is not None or (ci == 0 and need_downsample)

        coef, badv = dequant(coef16, qraw_t)
        coef_dq = coef
        canceled = False
        if opts.precise:
            # row chunks cut where the running counter crosses prog_thr;
            # a chunk reads the whole pre-iteration plane and writes only
            # its rows, so after a cancel the later rows keep their
            # previous values (the reference's `if (stop) continue`)
            prog_inc = comp.v_samp_factor
            for _ in range(num_iter2):
                pix = cuda_solver.idct_pix(coef)
                nbhd = neighbourhood(pix, img2, flags, hb, wb)
                new = coef.clone()      # updated in place, chunk by chunk
                rows_done = 0
                while rows_done < hb:
                    need = prog_thr - prog_cur
                    chunk = min(max(1, -(-need // prog_inc)), hb - rows_done)
                    new[:, rows_done * wb:(rows_done + chunk) * wb] = \
                        block_pass(coef, nbhd, img2, div, x1, qshr, flags,
                                   luma, wb, rows=(rows_done, chunk))
                    rows_done += chunk
                    prog_cur += chunk * prog_inc
                    if report_progress():
                        canceled = True
                        break
                coef = new
                if canceled:
                    break
        else:
            for _ in range(num_iter2):
                pix = cuda_solver.idct_pix(coef)
                coef = block_pass(coef, neighbourhood(pix, img2, flags, hb,
                                                      wb),
                                  img2, div, x1, qshr, flags, luma, wb)
                prog_cur += hb * comp.v_samp_factor
                if report_progress():
                    canceled = True
                    break
        # the final stage (quantsmooth.h:2668-2689): the plane the colour
        # paths read, the guard's fallback, the +-1023 clamp
        padded = None
        if want_plane and not canceled:
            padded = planar.pix_to_plane(cuda_solver.idct_pix(coef), hb, wb)
        coef = torch.clamp(torch.where(badv, coef_dq, coef), -1023, 1023)
        res.coefs[ci] = coef.to(I16).T.contiguous().cpu().numpy().reshape(
            hb, wb, 64)
        if canceled or bool(badv):
            stop = 1
            continue

        if image1 is not None:
            hbl, wbl = comps[0].height_in_blocks, comps[0].width_in_blocks
            up_planes[ci] = upsample_fdct_plane(
                padded, image2, image1, img.width, img.height,
                comps[0].h_samp_factor, comps[0].v_samp_factor, hbl,
                wbl).cpu().numpy()
        elif ci == 0 and need_downsample:
            ws, hs = comp.h_samp_factor, comp.v_samp_factor
            if ws == 1 and hs == 1:
                image2 = padded
            else:
                if flags & UPSAMPLE_UV:
                    image1 = padded
                image2 = downsample_plane(
                    padded, hb, wb, comps[1].height_in_blocks,
                    comps[1].width_in_blocks, ws, hs)

    if stop:
        image1 = None
    if image1 is not None and 1 in up_planes and 2 in up_planes:
        res.upsampled = (up_planes[1], up_planes[2])
    res.stop = stop
    return res


# ---------------------------------------------------------------------------
# Auto-sharding over several CUDA devices (engine._shard_grid and
# _try_smooth_sharded of the JAX package)
# ---------------------------------------------------------------------------

def shard_devices(dev: torch.device) -> list:
    """The devices ``smooth`` shards over: every CUDA device, when the
    card is asked for without an index and there is more than one; else
    none."""
    if dev.type != "cuda" or dev.index is not None \
            or torch.cuda.device_count() < 2:
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _shard_grid(img, opts: QsOptions, ndev: int, allow_col=True):
    """The (rows, cols) shard grid for auto-sharding over ``ndev``
    devices, or None: more than one device, at least one iteration, an
    image of at least JPEGQS_SHARD_MIN_BLOCKS blocks (default 16384:
    smaller ones do not beat the exchanges' overhead), clean quant tables
    (the val<=1 and crafted-file shortcuts stay on one device) and
    sampling factors up to 2.  Pad-to-divisible sharding lets any count
    use every device: rows are taken first, up to the smallest
    component's block rows; columns pick up devices (``allow_col``) only
    when an image has fewer block rows than devices (line-scan strips,
    panoramas)."""
    import os

    comps = img.components
    if ndev < 2 or opts.niter < 1 or not comps:
        return None
    min_blocks = int(os.environ.get("JPEGQS_SHARD_MIN_BLOCKS", "16384"))
    if sum(c.height_in_blocks * c.width_in_blocks for c in comps) \
            < min_blocks:
        return None
    if comps[0].h_samp_factor > 2 or comps[0].v_samp_factor > 2:
        return None
    for c in comps:
        val = int(np.bitwise_or.reduce(np.asarray(c.quantval, np.int32)))
        if val <= 1 or val >= 0x800:
            return None
    r = min(ndev, min(c.height_in_blocks for c in comps))
    c = 1
    if allow_col and r < ndev:
        c = max(1, min(ndev // r, min(x.width_in_blocks for x in comps)))
    return (r, c) if r * c >= 2 else None


def choose_grid(img, opts: QsOptions, ndev: int):
    """_shard_grid's grid, or where a colour flow with UPSAMPLE_UV would
    leave its luma fewer than two block columns a shard (its right tail's
    source column must stay in the shard) the best row-only grid; None
    where sharding does not apply."""
    grid = _shard_grid(img, opts, ndev)
    if grid is not None and grid[1] > 1 and \
            _need_downsample(img, opts.flags) and \
            opts.flags & UPSAMPLE_UV and \
            img.components[0].width_in_blocks // grid[1] < 2:
        grid = _shard_grid(img, opts, ndev, allow_col=False)
    return grid


def shard_layout(devices, grid):
    """The first rows x cols of ``devices`` as make_sharded_smooth and
    make_sharded_ycbcr_smooth take them: a flat list for one column, else
    a list of rows."""
    r, c = grid
    devices = list(devices)[:r * c]
    return devices if c == 1 else [devices[i * c:(i + 1) * c]
                                    for i in range(r)]


def _try_smooth_sharded(img, opts: QsOptions, devices):
    """The image smoothed with its block grid sharded over ``devices``
    (a device may repeat), or None where sharding does not apply: no
    iteration, the grid choice declines (choose_grid), or
    _smooth_on_shards declines."""
    from .parallel import sharded

    if min(max(opts.niter, 0), ITER_MAX) == 0:
        return None             # dequant-only: the fused path models it
    grid = choose_grid(img, opts, len(devices))
    if grid is None:
        return None
    return _smooth_on_shards(img, opts,
                             sharded.Shards(shard_layout(devices, grid)))


def _smooth_on_shards(img, opts: QsOptions, shards):
    """The image smoothed on ``shards`` (a parallel/sharded.Shards: the
    devices of this process, or of every rank of a multi-process job),
    or None where a YCbCr colour flow's planes are not aligned or it has
    more than three components.  The YCbCr colour flow runs its three
    components together; otherwise each component runs on its own, with
    the crafted-file stop propagated from one to the next."""
    from .parallel import sharded

    comps = img.components
    flags = opts.flags
    niter = min(max(opts.niter, 0), ITER_MAX)

    def tabs(ci):
        qraw = np.asarray(comps[ci].quantval, np.int32)
        return (qraw, *make_quant_tables(qraw))

    def plane(c):
        return np.asarray(c.coefs, np.int16).reshape(
            c.height_in_blocks, c.width_in_blocks, 64)

    res = SmoothResult()
    res.coefs = [np.asarray(c.coefs, dtype=np.int16).copy() for c in comps]
    if _need_downsample(img, flags):
        y, cb, cr = comps[:3]
        ws, hs = y.h_samp_factor, y.v_samp_factor
        aligned = (y.height_in_blocks == hs * cb.height_in_blocks
                   and y.width_in_blocks == ws * cb.width_in_blocks
                   and cb.height_in_blocks == cr.height_in_blocks
                   and cb.width_in_blocks == cr.width_in_blocks)
        if not aligned or len(comps) != 3:
            return None
        fn = sharded.make_sharded_ycbcr_smooth(
            shards, hb_l=y.height_in_blocks, wb_l=y.width_in_blocks,
            hb_c=cb.height_in_blocks, wb_c=cb.width_in_blocks, ws=ws, hs=hs,
            flags=flags, niter=niter, img_w=img.width, img_h=img.height)
        oy, ocb, ocr, badv, ups = fn(plane(y), plane(cb), plane(cr),
                                     tabs(0), tabs(1), tabs(2))
        res.coefs[:3] = [o.cpu().numpy() for o in (oy, ocb, ocr)]
        res.stop = int(bool(badv))
        if ups is not None and not res.stop:
            res.upsampled = tuple(u.cpu().numpy() for u in ups)
        return res

    # independent per-component sharding (gray, colour without the
    # colour paths, non-YCbCr components)
    dev0 = shards.first
    for ci, comp in enumerate(comps):
        qraw = np.asarray(comp.quantval, np.int32)
        if not qraw.any():
            continue
        hb, wb = comp.height_in_blocks, comp.width_in_blocks
        if res.stop:
            # later components: plain dequantization, unclamped
            res.coefs[ci] = dequant_only(
                torch.from_numpy(res.coefs[ci].reshape(hb * wb, 64)).to(dev0),
                torch.from_numpy(qraw).to(dev0)).cpu().numpy(
            ).reshape(hb, wb, 64)
            continue
        fn = sharded.make_sharded_smooth(
            shards, hb=hb, wb=wb, flags=flags, niter=niter,
            luma=(ci == 0) or not img.is_ycbcr)
        out, badv = fn(plane(comp), *tabs(ci))
        # the tripping component itself keeps the guard's fallback,
        # clamped (quantsmooth.h:2596-2610, 2668-2689)
        res.coefs[ci] = out.cpu().numpy()
        res.stop = int(bool(badv))
    return res


def smooth(img, opts: QsOptions, device=None) -> SmoothResult:
    """Run the engine on a decoded-to-coefficients JPEG
    (host.jpegio.JpegImage), on the card unless ``device="cpu"``.

    Without a progress callback the whole image runs as one sequence of
    device passes with no host round trip between components, its block
    rows sharded over every card when there is more than one (and the
    image is large enough, _shard_grid); with one it runs component by
    component and pass by pass so the callback can fire (and cancel)
    between them (_smooth_percomp).  An allocation failure, on the card
    or on the CPU (_is_oom), degrades to plain host-side dequantization,
    like the reference's malloc-failure path; every other error
    propagates."""
    dev = resolve_device(device)
    try:
        if opts.progress is None:
            devices = shard_devices(dev)
            res = _try_smooth_sharded(img, opts, devices) if devices else None
            return res if res is not None else _smooth_fused(img, opts, dev)
        return _smooth_percomp(img, opts, dev)
    except Exception as e:
        if not _is_oom(e):
            raise
        return _smooth_degraded(img, opts)


def _is_oom(e) -> bool:
    """An allocation failure, the condition the reference meets with its
    malloc-failure degradation (quantsmooth.h:2548-2566; the port's copy
    of jpegqs_tpu.engine._is_oom): torch's OutOfMemoryError, the JAX
    package's out-of-memory texts, or the CPU allocator's failure, a
    plain RuntimeError ("DefaultCPUAllocator: can't allocate memory").
    A kernel that did not build or launch (_build.KernelError) is never
    one."""
    if isinstance(e, KernelError):
        return False
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s
            or ("DefaultCPUAllocator" in s
                and ("can't allocate memory" in s
                     or "not enough memory" in s)))


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


def decode_smoothed(data: bytes, opts: QsOptions = None,
                    device=None) -> np.ndarray:
    """Decode a JPEG with smoothing applied, the library decode path
    (reference: jpegqs_start_decompress, quantsmooth.h:2882-2905,
    example.c:78-144): uint8 pixels (H, W) or (H, W, 3), on the card
    unless ``device="cpu"``.  The pixels are decoded on the device from
    the smoothed coefficient planes (ops/colorout.py), with no re-encode;
    layouts it does not model (non-YCbCr with several components, CMYK,
    sampling other than 1x1 / 2x1 / 2x2) go through a re-encode and
    libjpeg's decode.  Both give the same pixels."""
    from .host.jpegio import decode_pixels, read_coefficients

    dev = resolve_device(device)
    if opts is None:
        opts = QsOptions.from_quality(3, 3)
    img = read_coefficients(data)
    res = smooth(img, opts, dev)
    out = _decode_native(img, res, dev)
    if out is not None:
        return out
    return decode_pixels(_save_result(data, res))


def _decode_native(img, res: SmoothResult, device=None):
    """Device pixel decode of a SmoothResult (engine._decode_native), or
    None when the layout needs the libjpeg fallback (decode_smoothed).
    One B1 launch per component on the card."""
    from .ops import colorout

    dev = resolve_device(device)
    layout = decode_layout(img, res)
    if layout is None:
        return None
    planes, dims, ws, hs = layout
    planes = [torch.from_numpy(np.ascontiguousarray(p, np.int16)).to(dev)
              for p in planes]
    return colorout.decode(planes, dims, ws, hs, img.height,
                           img.width).cpu().numpy()


def decode_layout(img, res: SmoothResult):
    """What the device decode of a SmoothResult reads: (planes, dims, ws,
    hs) -- the gray plane, or the Y, Cb and Cr planes (the upsampled ones
    after UPSAMPLE_UV), each with its (hb, wb, oh, ow), and the chroma's
    upsampling factors -- or None where the layout needs the libjpeg
    fallback: a non-YCbCr image of several components, or sampling other
    than 1x1 / 2x1 / 2x2 with 1x1 chroma."""
    comps = img.components
    H, W = img.height, img.width
    if len(comps) == 1:
        c = comps[0]
        return ((res.coefs[0],), ((c.height_in_blocks, c.width_in_blocks, H,
                                   W),), 1, 1)
    if len(comps) != 3 or not img.is_ycbcr:
        return None
    if res.upsampled is not None:
        # UPSAMPLE_UV output: all components at luma dims, 1x1 sampled
        hb, wb = comps[0].height_in_blocks, comps[0].width_in_blocks
        return ((res.coefs[0], res.upsampled[0], res.upsampled[1]),
                ((hb, wb, H, W),) * 3, 1, 1)
    ws, hs = comps[0].h_samp_factor, comps[0].v_samp_factor
    if (ws, hs) not in ((1, 1), (2, 1), (2, 2)):
        return None
    if any(c.h_samp_factor != 1 or c.v_samp_factor != 1 for c in comps[1:]):
        return None
    dims = tuple((c.height_in_blocks, c.width_in_blocks,
                  -(-H * c.v_samp_factor // hs), -(-W * c.h_samp_factor // ws))
                 for c in comps)
    return tuple(res.coefs), dims, ws, hs


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
