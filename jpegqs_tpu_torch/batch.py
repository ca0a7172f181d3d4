"""Batch engine: many-image throughput, the port of ``jpegqs_tpu.batch``.

- ``smooth_corpus`` / ``smooth_many``: the corpus pipeline.  Entropy
  decode on a thread pool, images bucketed by (geometry, quant-table)
  signature, each bucket run as batches of up to ``max_batch`` images
  with up to ``window`` batches queued on the card, and re-encode on the
  pool while later batches compute.
- ``smooth_plane_batch``: N same-shape gray planes sharing a quant table
  through one component pass over N*B blocks.
- ``smooth_image_batch``: N same-plan images (any quality level,
  JOINT_YUV and UPSAMPLE_UV included) through one whole-image run
  (``engine.run_image`` with ``n``): the kernels B1-B4 see one block axis
  of N images back to back and take each image's edges from ``b % (hb *
  wb)``; the guard, the stop, the downsample, the halos and the upsample
  keep the image axis.  The launches do not grow with N.

The JAX package pads a batch up to a size of its ``_BATCH_SIZES`` ladder
so that XLA reuses compiled program shapes.  The port compiles nothing
per shape, so it runs the exact N: no image's result depends on its
neighbours on the block axis, so padding could only add work.

Output is bit-identical to the port's per-image ``engine.smooth`` and to
``jpegqs_tpu.batch``.  Entry points run on the card unless
``device="cpu"``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import engine
from .options import QsOptions
from .ops.quant import make_quant_tables


def _img_sig(img):
    """Bucket signature: everything the batch's plan depends on."""
    return (img.width, img.height, img.jpeg_color_space,
            tuple((c.h_samp_factor, c.v_samp_factor,
                   c.width_in_blocks, c.height_in_blocks,
                   c.quantval.tobytes()) for c in img.components))


def smooth_corpus(datas, opts: QsOptions = None, workers: int = 8,
                  optimize: bool = False, copy_markers: int = 2,
                  max_batch: int = 16, window: int = 4,
                  warnings_out: list = None, device=None):
    """Smooth a mixed corpus of JPEG byte strings; outputs in order.

    Entropy decode on a thread pool; bucket by (geometry, qtables)
    signature; each bucket runs as batches of up to ``max_batch`` images,
    with up to ``window`` batches queued on the device while finished
    ones re-encode on the pool.  Unbatchable leftovers (a bucket of one,
    sampling factors above 2, a progress callback) go through the
    per-image engine between the batches.  After everything ran, the
    first input that failed to decode raises.

    ``warnings_out``: optional list; the total libjpeg corrupt-data
    warning count over all files (decode + encode) is appended, so a
    caller can mirror the reference CLI's exit code 2
    (quantsmooth.c:626)."""
    from .host.jpegio import JpegCoefFile

    dev = engine.resolve_device(device)
    if opts is None:
        opts = QsOptions.from_quality(3, 3)
    n = len(datas)
    if n == 0:
        return []
    outs = [None] * n
    errors = [None] * n

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as ex:
        def open_read(i):
            f = None
            try:
                f = JpegCoefFile(datas[i], copy_markers=copy_markers)
                return f, f.read()
            except Exception as e:            # keep pipeline order
                if f is not None:
                    f.close()
                return None, e

        decoded = list(ex.map(open_read, range(n)))
        files = [d[0] for d in decoded]
        imgs = [d[1] for d in decoded]

        try:
            return _corpus_pipeline(
                ex, files, imgs, errors, outs, opts, optimize, max_batch,
                window, warnings_out, dev)
        finally:
            # close() is idempotent: encode_one closed the encoded
            # handles; this releases what an error path left open
            for f in files:
                if f is not None:
                    f.close()


def _corpus_pipeline(ex, files, imgs, errors, outs, opts, optimize,
                     max_batch, window, warnings_out, dev):
    n = len(files)
    buckets = {}
    for i in range(n):
        if files[i] is None:
            errors[i] = imgs[i]
            continue
        buckets.setdefault(_img_sig(imgs[i]), []).append(i)

    # the dispatch plan: large buckets first keep the device busiest
    # while small or odd ones trickle through the per-image engine
    plan = []
    for idxs in sorted(buckets.values(), key=len, reverse=True):
        comp0 = imgs[idxs[0]].components[0]
        batchable = (len(idxs) > 1 and opts.progress is None
                     and comp0.h_samp_factor <= 2
                     and comp0.v_samp_factor <= 2)
        if batchable:
            for c0 in range(0, len(idxs), max_batch):
                plan.append(idxs[c0:c0 + max_batch])
        else:
            plan.extend([i] for i in idxs)

    def encode_one(i, res):
        f = files[i]
        for ci in range(len(imgs[i].components)):
            f.write_coefs(ci, res.coefs[ci])
        if res.upsampled is not None:
            f.set_upsampled(res.upsampled[0], res.upsampled[1])
        out = f.save(optimize=optimize)
        nw = f.num_warnings()   # decode + encode (quantsmooth.c:626)
        f.close()
        return out, nw

    enc_futs = []
    inflight = []   # (chunk, assemble): dispatched, not yet drained

    def drain_one():
        chunk, asm = inflight.pop(0)
        results = (asm() if asm is not None
                   else [engine.smooth(imgs[i], opts, dev) for i in chunk])
        for i, res in zip(chunk, results):
            enc_futs.append((i, ex.submit(encode_one, i, res)))

    for chunk in plan:
        asm = None
        if len(chunk) > 1:
            asm = _batch_dispatch([imgs[i] for i in chunk], opts, dev)
        inflight.append((chunk, asm))
        while len(inflight) > window:
            drain_one()
    while inflight:
        drain_one()

    total_warnings = 0
    for i, fut in enc_futs:
        outs[i], nw = fut.result()
        total_warnings += nw
    if warnings_out is not None:
        warnings_out.append(total_warnings)

    for err in errors:
        if err is not None:
            raise err
    return outs


def smooth_many(datas, opts: QsOptions = None, workers: int = 4,
                optimize: bool = False, device=None):
    """Smooth a list of JPEG byte strings; returns the outputs in order.

    The corpus pipeline (decode -> bucketed batches -> encode,
    overlapped); see ``smooth_corpus`` for the knobs."""
    return smooth_corpus(datas, opts, workers=workers, optimize=optimize,
                         device=device)


def smooth_plane_batch(coefs, qtbl, flags: int, niter: int,
                       luma: bool = True, device=None):
    """Smooth N same-shape coefficient planes sharing one quant table.

    coefs int16[N, hb, wb, 64]; qtbl uint16/int32[64].  Returns
    int16[N, hb, wb, 64] (each plane's guard fallback, clamped; quant=1
    semantics)."""
    dev = engine.resolve_device(device)
    coefs = np.asarray(coefs, dtype=np.int16)
    n, hb, wb, _ = coefs.shape
    qraw = np.asarray(qtbl, dtype=np.int32)
    tabs = [engine.stack_to([t], dev)
            for t in (qraw, *make_quant_tables(qraw))]
    out, _, _ = engine.component_smooth(
        engine.stack_to([coefs.reshape(n * hb * wb, 64)], dev), *tabs,
        hb=hb, wb=wb, flags=flags, niter=niter, luma=luma, n=n)
    return engine.download([out.to(torch.int16)])()[0].reshape(n, hb, wb,
                                                                64)


def _batch_dispatch(imgs, opts: QsOptions, dev):
    """Queue one uniform batch on the device (``engine.dispatch``).

    Returns ``assemble() -> [SmoothResult]``, which waits for this
    batch's host copies alone, or None when the batch cannot run as one
    (the caller smooths image by image)."""
    plan = engine.plan_image(imgs[0], opts)
    if plan is None or (plan.need_downsample and not plan.ds_blocks):
        return None
    return engine.dispatch(imgs, plan, dev)


def smooth_image_batch(imgs, opts: QsOptions = None, device=None):
    """Smooth N decoded images with identical geometry and quant tables
    in one whole-image run; returns a list of engine.SmoothResult.

    Falls back to per-image ``engine.smooth`` where the JAX package does:
    a batch that is not uniform (``_img_sig``), sampling factors above 2,
    a progress callback, a single image, or a plan that needs the plane
    form or runs nothing."""
    dev = engine.resolve_device(device)
    if opts is None:
        opts = QsOptions.from_quality(3, 3)
    if not imgs:
        return []
    return dispatch_image_batch(imgs, opts, dev)()


def dispatch_image_batch(imgs, opts: QsOptions, dev):
    """smooth_image_batch's work on device ``dev``, queued: returns
    ``assemble() -> [SmoothResult]``, which waits for this batch's copies
    alone.  The per-image fallbacks run at once."""
    first = imgs[0]
    uniform = (all(_img_sig(im) == _img_sig(first) for im in imgs[1:])
               and first.components[0].h_samp_factor <= 2
               and first.components[0].v_samp_factor <= 2
               and opts.progress is None)
    assemble = None
    if uniform and len(imgs) > 1:
        assemble = _batch_dispatch(imgs, opts, dev)
    if assemble is None:
        results = [engine.smooth(im, opts, dev) for im in imgs]
        return lambda: results
    return assemble
