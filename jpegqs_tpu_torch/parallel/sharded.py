"""Row-sharded smoothing over a list of devices: the port of the row flow
of ``jpegqs_tpu/parallel/sharded.py``.

The reference's only parallelism is OpenMP over the block rows of one
plane (quantsmooth.h:2552-2554); the JAX package shards the block rows
of each component plane over a mesh axis with ``shard_map`` and
exchanges the 1-pixel halo between neighbours with ``ppermute`` (the
OpenMP barrier between the IDCT and the block pass, 2609 -> 2624).  Its
counterpart here is one Python process driving a list of
``torch.device``s, shard r on ``devices[r]``:

- each shard's tensors live on its own device, and a device may appear
  more than once (``["cuda:0"] * 4`` runs four shards on one card,
  ``["cpu"] * 4`` four on the CPU with the kernels' plain versions);
- each shard holds its block rows with one ghost block row above and one
  below; every iteration copies the neighbours' boundary pixel lines
  into the ghosts (``_exchange_ghosts``), then kernel B7
  (``cuda_solver.solve_range_pix``) runs one pass over the shard's real
  rows, with the image's edges where they really are: the top edge on
  the first shard, the bottom edge on the shard that holds the last real
  block row (pad-to-divisible sharding may put it mid-shard, with dead
  zero rows below);
- on the card the copies run on a side stream per device, ordered with
  CUDA events, so nothing waits on the host inside the ``niter`` loop;
  with ``JPEGQS_OVERLAP=1`` the interior rows, which read no ghost line,
  are computed while the copies are in flight.

Outputs, pixels and the stop flag are bit-identical to the single-device
engine: every block sees the same neighbourhood.  Not ported yet: the
2-D row x column grid, batch data parallelism, and the multi-process
engine over ``torch.distributed``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import engine
from ..options import JOINT_YUV, UPSAMPLE_UV
from ..ops import cuda_solver, planar

I32 = torch.int32
I16 = torch.int16
F32 = torch.float32
CENTERJSAMPLE = 128


def _pad_to(x, m):
    """Smallest multiple of m >= x."""
    return -(-x // m) * m


def _edge_pos(real, loc):
    """(rank, local index) of the LAST REAL block row when ``real`` rows,
    padded with dead zero rows to a multiple of the shard count, are
    split into per-shard chunks of ``loc``: the image's bottom edge, where
    edge replication (quantsmooth.h:2612-2620) happens, may lie
    mid-shard."""
    return (real - 1) // loc, (real - 1) % loc


def _overlap_enabled():
    """JPEGQS_OVERLAP=1: split each sharded pass into interior and
    boundary launches so the ghost exchange overlaps interior compute."""
    return os.environ.get("JPEGQS_OVERLAP", "0") not in ("0", "", "false")


class Shards:
    """The devices of a row-sharded run, one per shard (a device may
    repeat), and on the card one exchange stream per device."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        kinds = {d.type for d in self.devices}
        if not self.devices or len(kinds) > 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"shards need CPU devices only or CUDA devices "
                             f"only, got {devices}")
        self.n = len(self.devices)
        self.on_cuda = kinds == {"cuda"}
        self._side = {}

    def side(self, dev):
        """The exchange stream of CUDA device ``dev``."""
        key = torch.device(dev.type, dev.index or 0)
        if key not in self._side:
            self._side[key] = torch.cuda.Stream(device=key)
        return self._side[key]

    def record(self):
        """An event on each shard's current stream (None on the CPU)."""
        if not self.on_cuda:
            return None
        events = []
        for d in self.devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
        return events

    def put(self, x, r):
        """numpy array or tensor ``x`` on shard r's device."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(self.devices[r], non_blocking=True)

    def split_rows(self, x, rows, rows_pad):
        """Leading axis of ``x`` (``rows`` long) padded with zeros to
        ``rows_pad`` and cut into one chunk per shard, each on its
        device."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        assert t.shape[0] == rows, (tuple(t.shape), rows)
        if rows_pad > rows:
            pad = torch.zeros((rows_pad - rows,) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            t = torch.cat([t, pad])
        return [self.put(c, r) for r, c in enumerate(t.chunk(self.n))]

    def gather(self, parts, dim=0):
        """Concatenation of per-shard tensors on the first shard's
        device."""
        dev = self.devices[0]
        return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim)

    def any(self, flags):
        """The OR of per-shard bool scalars (the JAX package's pmax), as a
        copy on each shard's device."""
        tot = flags[0]
        for f in flags[1:]:
            tot = tot | f.to(tot.device, non_blocking=True)
        return [tot.to(d, non_blocking=True) for d in self.devices]


# ---------------------------------------------------------------------------
# The 1-pixel halo across shards for the colour glue (one exchange per
# component, outside the niter loop)
# ---------------------------------------------------------------------------

def _row_halo_blocks(pixs, hb_loc, wb):
    """Per shard (above, below) int32[8(col), wb]: the pixel line next to
    the shard's first / last block row -- the neighbour shard's edge
    line, or the shard's own edge line at the first / last shard (edge
    replication, quantsmooth.h:2612-2620).  pixs: per shard int32[8, 8,
    hb_loc*wb]."""
    p = [x.reshape(8, 8, hb_loc, wb) for x in pixs]
    n = len(p)
    out = []
    for r in range(n):
        dev = p[r].device
        above = (p[r][0, :, 0, :] if r == 0
                 else p[r - 1][7, :, -1, :].to(dev, non_blocking=True))
        below = (p[r][7, :, -1, :] if r == n - 1
                 else p[r + 1][0, :, 0, :].to(dev, non_blocking=True))
        out.append((above, below))
    return out


def blocks_halo10_sharded(pixs, hb_loc, wb, row_edge):
    """Sharded counterpart of planar.blocks_halo10: per shard the
    [10, 10, hb_loc*wb] block neighbourhoods, with the cross-shard lines
    exchanged.  The vertical halo goes on before the horizontal gather,
    so corners come out as in the single-device version.  ``row_edge``:
    (rank, local row) of the last REAL block row (_edge_pos)."""
    er, el = row_edge
    halos = []
    for r, ((above, below), pix) in enumerate(
            zip(_row_halo_blocks(pixs, hb_loc, wb), pixs)):
        p4 = pix.reshape(8, 8, hb_loc, wb)
        up = torch.cat([above[None, :, None, :], p4[7:8, :, :-1, :]], dim=2)
        dn = torch.cat([p4[0:1, :, 1:, :], below[None, :, None, :]], dim=2)
        if r == er:
            # the last REAL block row's bottom line is its own pixel row
            # 7, not the dead pad row below it (the JAX _fix_dn_edge)
            dn[0, :, el, :] = p4[7, :, el, :]
        mid = torch.cat([up, p4, dn])                      # [10, 8, hb, wb]
        left = torch.cat([mid[:, 0:1, :, :1], mid[:, 7:8, :, :-1]], dim=3)
        right = torch.cat([mid[:, 0:1, :, 1:], mid[:, 7:8, :, -1:]], dim=3)
        halos.append(torch.cat([left, mid, right], dim=1).reshape(
            10, 10, hb_loc * wb))
    return halos


# ---------------------------------------------------------------------------
# The resident loop on ghost-extended shards
# ---------------------------------------------------------------------------

def _copy_on(shards, dst, src):
    """dst.copy_(src) on the exchange streams of both devices."""
    with contextlib.ExitStack() as stack:
        for dev in {dst.device, src.device}:
            stack.enter_context(torch.cuda.stream(shards.side(dev)))
        dst.copy_(src, non_blocking=True)


def _exchange_ghosts(pix, hb_loc, wb, shards, ready=None):
    """Copy the boundary pixel lines into the ghost block rows of each
    shard's pixels pix[r] int32[64, (hb_loc+2)*wb]: the top ghost row
    receives pixel rows 56..63 of the upper shard's last row, the bottom
    ghost row pixel rows 0..7 of the lower shard's first.  Edge shards
    keep their ghosts: no edge flag lets a kernel read them.

    On the card the copies into shard r run on the exchange stream once
    ``ready`` (events of every shard's current stream, recorded when its
    pixels were final) has passed on shards r-1, r and r+1; each shard's
    current stream then waits for its own and its neighbours' copies, so
    nothing waits on the host.  The copies run inside a profiler range,
    "jpegqs_exchange"."""
    n = shards.n
    if n == 1:
        return
    last, bot = hb_loc * wb, (hb_loc + 1) * wb
    near = [range(max(r - 1, 0), min(r + 2, n)) for r in range(n)]
    if shards.on_cuda and ready is None:
        ready = shards.record()
    done = []
    with torch.profiler.record_function("jpegqs_exchange"):
        for r in range(n):
            copies = []
            if r > 0:
                copies.append((pix[r][56:64, :wb],
                               pix[r - 1][56:64, last:bot]))
            if r < n - 1:
                copies.append((pix[r][0:8, bot:bot + wb],
                               pix[r + 1][0:8, wb:2 * wb]))
            if not shards.on_cuda:
                for dst, src in copies:
                    dst.copy_(src)
                continue
            side = shards.side(shards.devices[r])
            for k in near[r]:
                side.wait_event(ready[k])
            for dst, src in copies:
                _copy_on(shards, dst, src)
            ev = torch.cuda.Event()
            ev.record(side)
            done.append(ev)
    if not shards.on_cuda:
        return
    for r in range(n):
        cur = torch.cuda.current_stream(shards.devices[r])
        for k in near[r]:
            cur.wait_event(done[k])


def _sharded_resident_iters(coefs, img2_halos, tabs, flags, luma, hb_loc, wb,
                            niter, extra_refresh, shards, row_edge):
    """The sharded loop on resident planes: per shard the B1 bootstrap,
    then ``niter`` x (ghost exchange, B7 over the shard's real rows).

    coefs: per shard the dequantized coefficients int32[64, hb_loc*wb];
    img2_halos: per shard int32[100, hb_loc*wb] (JOINT_YUV preamble) or
    None; tabs: per shard (div, x1, qshr).  Returns per shard (coef',
    pix'), pix' the pixels of the last pass that emitted them (the
    bootstrap when none did).  Ghost blocks are never computed, nor the
    dead pad rows past the image's bottom edge."""
    n = shards.n
    B = hb_loc * wb
    er, el = row_edge
    do_reb = engine._do_rebalance(flags, luma)

    def embed(x):                       # [R, B] -> [R, (hb_loc+2)*wb]
        return torch.nn.functional.pad(x, (wb, wb))

    coef_a = [embed(c) for c in coefs]
    coef_b = [torch.zeros_like(c) for c in coef_a]
    # the ghosts' pixels stay as the bootstrap left them until the
    # exchange overwrites the lines a kernel reads
    pix_a = [cuda_solver.idct_pix(c) for c in coef_a]
    pix_b = [torch.zeros_like(p) for p in pix_a]
    img2 = [None if h is None else embed(h) for h in img2_halos]
    rows = [hb_loc if r < er else (el + 1 if r == er else 0)
            for r in range(n)]
    edges = [(1 if r == 0 else -1, el + 1 if r == er else -1)
             for r in range(n)]
    overlap = _overlap_enabled()
    # with the split, rows 2 .. rows-1 read no ghost line: they go before
    # the exchange, rows 1 and ``rows`` after it
    split = [overlap and k >= 3 for k in rows]

    def run(r, row0, row1, keep):
        cuda_solver.solve_range_pix(
            coef_a[r], pix_a[r], img2[r], *tabs[r], flags, do_reb, wb,
            row0 * wb, row1 * wb, edges[r], coef_b[r],
            pix_b[r] if keep else None)

    for it in range(niter):
        keep = it < niter - 1 or bool(extra_refresh)
        ready = shards.record()
        for r in range(n):
            if split[r]:
                run(r, 2, rows[r], keep)
        _exchange_ghosts(pix_a, hb_loc, wb, shards, ready)
        for r in range(n):
            if split[r]:
                run(r, 1, 2, keep)
                run(r, rows[r], rows[r] + 1, keep)
            elif rows[r]:
                run(r, 1, rows[r] + 1, keep)
        coef_a, coef_b = coef_b, coef_a
        if keep:
            pix_a, pix_b = pix_b, pix_a
    return ([c[:, wb:wb + B] for c in coef_a],
            [p[:, wb:wb + B] for p in pix_a])


def _component_body(coef16s, tabs, img2_halos, *, hb_loc, wb, flags, niter,
                    extra_refresh, luma, shards, row_edge):
    """One component on its shards (the JAX package's _component_body):
    the dequantization with the crafted-file guard ORed over the shards
    (quantsmooth.h:2596-2610), the resident loop, the guard's fallback and
    the +-1023 clamp.  coef16s: per shard int16[hb_loc*wb, 64]; tabs: per
    shard (qraw, div, x1, qshr).  Returns per shard the coefficients
    int32[64, B], the pixels int32[64, B] and the OR of the guard."""
    deq = [engine.dequant(c, t[0]) for c, t in zip(coef16s, tabs)]
    badv = shards.any([d[1] for d in deq])
    coefs, pixs = _sharded_resident_iters(
        [d[0] for d in deq], img2_halos, [t[1:] for t in tabs], flags, luma,
        hb_loc, wb, niter, extra_refresh, shards, row_edge)
    outs = [torch.clamp(torch.where(b, d[0], c), -1023, 1023)
            for c, d, b in zip(coefs, deq, badv)]
    return outs, pixs, badv


def _tables(shards, qtabs):
    """(qraw, div, x1, qshr) on each shard's device."""
    return [tuple(shards.put(t, r) for t in qtabs) for r in range(shards.n)]


def make_sharded_smooth(devices, *, hb, wb, flags, niter, extra_refresh=0,
                        luma=True, use_image2=False, want_pix=False):
    """A row-sharded component smoother over ``devices`` (one shard each;
    a device may repeat).

    Returns fn(coef16, qraw, div, x1, qshr[, image2]) -> (coef int16[hb,
    wb, 64], badv bool[, pix int32[8, 8, hb*wb]]) on the first device.
    coef16 int16[hb, wb, 64] and the int32[64] tables may be numpy arrays
    or tensors.  Block rows that do not divide the shard count are
    padded with dead zero rows (no edge of theirs is read; they are cut
    from the result), so any plane uses every device.  With use_image2
    (JOINT_YUV chroma pass) image2 is the downsampled luma plane's
    interior int32[hb*8, wb*8]; its halos are exchanged like the plane's.
    ``want_pix``: also the final pixels (needs ``extra_refresh``)."""
    shards = Shards(devices)
    n = shards.n
    assert hb >= n, "more shards than block rows"
    hb_pad = _pad_to(hb, n)
    hb_loc = hb_pad // n
    row_edge = _edge_pos(hb, hb_loc)
    B = hb_loc * wb
    img2_live = use_image2 and bool(flags & JOINT_YUV)

    def run(coef16, qraw, div, x1, qshr, image2=None):
        coefs = [c.reshape(B, 64) for c in shards.split_rows(
            coef16.reshape(hb, wb, 64), hb, hb_pad)]
        img2 = [None] * n
        if img2_live:
            planes = shards.split_rows(image2, hb * 8, hb_pad * 8)
            ds = [planar.plane_to_fblocks_p(p, hb_loc, wb).to(I32)
                  for p in planes]
            img2 = [h.reshape(100, B)
                    for h in blocks_halo10_sharded(ds, hb_loc, wb, row_edge)]
        outs, pixs, badv = _component_body(
            coefs, _tables(shards, (qraw, div, x1, qshr)), img2,
            hb_loc=hb_loc, wb=wb, flags=flags, niter=niter,
            extra_refresh=extra_refresh, luma=luma, shards=shards,
            row_edge=row_edge)
        out = shards.gather([o.T.to(I16) for o in outs]).reshape(
            hb_pad, wb, 64)[:hb]
        if want_pix:
            pix = shards.gather(pixs, dim=1).reshape(8, 8, -1)[..., :hb * wb]
            return out, badv[0], pix
        return out, badv[0]

    run.padded_dims = (hb_pad, wb)
    return run


def make_sharded_ycbcr_smooth(devices, *, hb_l, wb_l, hb_c, wb_c, ws, hs,
                              flags, niter, img_w=None, img_h=None):
    """Row-sharded YCbCr smoothing, the reference flow quantsmooth.h:
    2484-2849 with UPSAMPLE_UV, over ``devices`` (one shard each).

    The three planes are sharded alike: the luma pass emits its pixels,
    which are box-downsampled shard by shard and halo-exchanged into the
    chroma JOINT_YUV passes; UPSAMPLE_UV regresses the full-resolution
    chroma shard by shard from the luma pixels.  Needs aligned dims (hb_l
    == hs*hb_c, wb_l == ws*wb_c), ws, hs in {1, 2}.  Chroma block rows
    are padded to a multiple of the shard count, the luma's to hs times
    that.  Returns fn(coef_y, coef_cb, coef_cr, qtabs_y, qtabs_c[,
    qtabs_cr]) -> (y, cb, cr, badv, ups): int16 planes [hb, wb, 64] on
    the first device, ups None or (up_cb, up_cr) int16[hb_l, wb_l, 64];
    qtabs_* are (qraw, div, x1, qshr) int32[64], Cr's defaulting to
    Cb's."""
    assert ws in (1, 2) and hs in (1, 2)
    assert hb_l == hs * hb_c and wb_l == ws * wb_c, "aligned dims only"
    shards = Shards(devices)
    n = shards.n
    assert hb_c >= n, "more shards than block rows"
    hb_c_pad = _pad_to(hb_c, n)
    hb_l_pad = hs * hb_c_pad
    hbl_loc, hbc_loc = hb_l_pad // n, hb_c_pad // n
    Bl, Bc = hbl_loc * wb_l, hbc_loc * wb_c
    edge_l, edge_c = _edge_pos(hb_l, hbl_loc), _edge_pos(hb_c, hbc_loc)
    img_w = wb_l * 8 if img_w is None else img_w
    img_h = hb_l * 8 if img_h is None else img_h
    do_up = bool(flags & UPSAMPLE_UV) and not (ws == 1 and hs == 1)

    def body(coefs, tabs, img2, hb_loc, wb, extra, luma, edge):
        return _component_body(coefs, tabs, img2, hb_loc=hb_loc, wb=wb,
                               flags=flags, niter=niter, extra_refresh=extra,
                               luma=luma, shards=shards, row_edge=edge)

    def upsample(pix_c, img2_halo, pix_y):
        """UPSAMPLE_UV of one chroma component, shard by shard (both
        replicate tails stay inside one shard)."""
        ch_halo = blocks_halo10_sharded(
            [p.reshape(8, 8, Bc) for p in pix_c], hbc_loc, wb_c, edge_c)
        parts = []
        for r in range(n):
            up = planar.upsample_chroma_blocks(
                ch_halo[r], img2_halo[r], pix_y[r].reshape(8, 8, Bl), img_w,
                img_h, ws, hs, hbl_loc, wb_l, hbc_loc, wb_c,
                row0=r * hbl_loc * 8, hb_l_total=hb_l)
            parts.append(engine.fdct_round_i16((up - CENTERJSAMPLE).to(F32),
                                               hbl_loc, wb_l))
        return shards.gather(parts)[:hb_l]

    def run(coef_y, coef_cb, coef_cr, qtabs_y, qtabs_c, qtabs_cr=None):
        if qtabs_cr is None:
            qtabs_cr = qtabs_c
        cy = [c.reshape(Bl, 64) for c in shards.split_rows(
            coef_y.reshape(hb_l, wb_l, 64), hb_l, hb_l_pad)]
        ccb, ccr = ([c.reshape(Bc, 64) for c in shards.split_rows(
            x.reshape(hb_c, wb_c, 64), hb_c, hb_c_pad)]
            for x in (coef_cb, coef_cr))
        ty, tcb, tcr = (_tables(shards, q) for q in (qtabs_y, qtabs_c,
                                                     qtabs_cr))
        # the plain-dequantized planes a tripped guard falls back to
        dq = [[engine.dequant_only(c, t[0]) for c, t in zip(cs, ts)]
              for cs, ts in ((cy, ty), (ccb, tcb), (ccr, tcr))]

        y, pix_y, bad_y = body(cy, ty, [None] * n, hbl_loc, wb_l, 1, True,
                               edge_l)
        img2_halo = None
        if flags & JOINT_YUV or do_up:
            ds = [planar.downsample_blocks(p.reshape(8, 8, Bl), hbl_loc, wb_l,
                                           hbc_loc, wb_c, ws, hs)
                  for p in pix_y]
            img2_halo = blocks_halo10_sharded(ds, hbc_loc, wb_c, edge_c)
        joint = ([h.reshape(100, Bc) for h in img2_halo]
                 if flags & JOINT_YUV else [None] * n)
        extra_c = 1 if do_up else 0
        cb, pix_cb, bad_cb = body(ccb, tcb, joint, hbc_loc, wb_c, extra_c,
                                  False, edge_c)
        cr, pix_cr, bad_cr = body(ccr, tcr, joint, hbc_loc, wb_c, extra_c,
                                  False, edge_c)

        # stop propagation (engine.run_image): once a component trips the
        # guard, the later ones come out plain-dequantized
        planes = []
        stop = [torch.zeros((), dtype=torch.bool, device=d)
                for d in shards.devices]
        for res, bad, d in ((y, bad_y, dq[0]), (cb, bad_cb, dq[1]),
                            (cr, bad_cr, dq[2])):
            planes.append(shards.gather([
                torch.where(s, dr, o.T.to(I16))
                for s, dr, o in zip(stop, d, res)]))
            stop = [s | b for s, b in zip(stop, bad)]
        oy = planes[0].reshape(hb_l_pad, wb_l, 64)[:hb_l]
        ocb, ocr = (p.reshape(hb_c_pad, wb_c, 64)[:hb_c] for p in planes[1:])
        ups = None
        if do_up:
            ups = (upsample(pix_cb, img2_halo, pix_y),
                   upsample(pix_cr, img2_halo, pix_y))
        return oy, ocb, ocr, stop[0], ups

    run.padded_dims = (hb_l_pad, wb_l, hb_c_pad, wb_c)
    return run
