"""Sharded smoothing over a layout of devices: the port of
``jpegqs_tpu/parallel/sharded.py``.

The reference's only parallelism is OpenMP over the block rows of one
plane (quantsmooth.h:2552-2554); the JAX package shards the block grid of
each component plane over a mesh with ``shard_map`` -- block rows on a
``row`` axis, and for images with fewer block rows than devices block
columns on a ``col`` axis too -- and exchanges the 1-pixel halo between
neighbours with ``ppermute`` (the OpenMP barrier between the IDCT and the
block pass, 2609 -> 2624).  Its counterpart here is one Python process
driving a layout of ``torch.device``s (``Shards``):

- a flat list is the row flow, shard r on ``devices[r]``; a list of rows
  of devices is a rows x columns grid, shard (r, c) on ``devices[r][c]``;
  a device may appear more than once (``["cuda:0"] * 4`` runs four shards
  on one card, ``[["cpu"] * 2] * 2`` a 2 x 2 grid on the CPU with the
  kernels' plain versions);
- each shard holds its block rows with one ghost block row above and one
  below and, on a grid of several columns, one ghost block column left and
  one right; every iteration copies the neighbours' boundary pixel lines
  into the ghosts (``_exchange_ghosts``: the rows, then the columns of the
  row-extended grids, so the corners are the diagonal shards' pixels), then
  kernel B7 (``cuda_solver.solve_range_pix``) runs one pass over the
  shard's real blocks, with the image's edges where they really are (the
  top / left edge on the first shard row / column, the bottom / right edge
  on the shard that holds the last real block row / column: pad-to-
  divisible sharding may put it mid-shard, with dead zero blocks beyond);
- on the card the copies run on a side stream per device, ordered with
  CUDA events, so nothing waits on the host inside the ``niter`` loop;
  with ``JPEGQS_OVERLAP=1`` (row flow only, as in the JAX package) the
  interior rows, which read no ghost line, are computed while the copies
  are in flight;
- in a multi-process job (parallel/multihost.py) each rank holds the
  shards of its own devices and the copies between ranks go over
  ``torch.distributed`` point to point.

``make_sharded_smooth(..., batch=True)`` is the JAX package's
``batch_axis``: a data x row layout, each group of devices smoothing its
share of the images, row-sharded over its own devices, with no traffic
between groups; ``smooth_batch_sharded`` does the same for whole images
(the colour paths included) through the engine.  ``dryrun_multichip``
mirrors ``__graft_entry__.dryrun_multichip``.

Outputs, pixels and the stop flag are bit-identical to the single-device
engine: every block sees the same neighbourhood.
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


def _pad_to(x, m):
    """Smallest multiple of m >= x."""
    return -(-x // m) * m


def _edge_pos(real, loc):
    """(shard, local index) of the LAST REAL block row (or column) when
    ``real`` rows, padded with dead zero rows to a multiple of the shard
    count, are split into per-shard chunks of ``loc``: the image's edge,
    where edge replication (quantsmooth.h:2612-2620) happens, may lie
    mid-shard."""
    return (real - 1) // loc, (real - 1) % loc


def _overlap_enabled():
    """JPEGQS_OVERLAP=1: split each sharded pass of the row flow into
    interior and boundary launches so the ghost exchange overlaps
    interior compute."""
    return os.environ.get("JPEGQS_OVERLAP", "0") not in ("0", "", "false")


# The point-to-point exchanges between ranks of a multi-process run (calls,
# host seconds from the first send's staging to the last receive, bytes
# sent), for the launcher's report; the single-process path never adds.
P2P = {"calls": 0, "seconds": 0.0, "bytes": 0}


def _is_grid(devices):
    return bool(devices) and isinstance(devices[0], (list, tuple))


class Shards:
    """The shards of a sharded run: a rows x cols grid, shard k = r * cols
    + c, each on a device (a device may repeat), and on the card one
    exchange stream per device.

    ``devices``: a flat list (one shard per block-row band, cols 1) or a
    list of rows of devices.  With ``group`` (a torch.distributed group in
    which every rank passes as many devices, a flat list, and the same
    ``cols``) the grid holds the shards of every rank, rank after rank in
    row-major order, and this process holds those of its own devices;
    per-shard lists then hold None at the other ranks' shards."""

    def __init__(self, devices, cols=None, group=None):
        if _is_grid(devices):
            if group is not None or cols is not None:
                raise ValueError("a multi-process grid takes a flat list of "
                                 "this rank's devices and cols")
            cols = len(devices[0])
            if any(len(row) != cols for row in devices):
                raise ValueError(f"ragged device grid {devices}")
            devices = [d for row in devices for d in row]
        local = [torch.device(d) for d in devices]
        kinds = {d.type for d in local}
        if not local or len(kinds) > 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"shards need CPU devices only or CUDA devices "
                             f"only, got {devices}")
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.per = len(local)
        self.n = self.per * self.world
        self.cols = cols or 1
        if self.n % self.cols:
            raise ValueError(f"{self.n} shards do not fill rows of "
                             f"{self.cols}")
        self.rows = self.n // self.cols
        self.mine = range(self.rank * self.per, (self.rank + 1) * self.per)
        self.devices = [None] * self.n
        for k, d in zip(self.mine, local):
            self.devices[k] = d
        self.first = local[0]
        self.on_cuda = kinds == {"cuda"}
        self._side = {}

    # -- layout --------------------------------------------------------

    def owner(self, k):
        return k // self.per

    def is_local(self, k):
        return self.rank * self.per <= k < (self.rank + 1) * self.per

    def pos(self, k):
        """(row, column) of shard k."""
        return divmod(k, self.cols)

    def nb(self, k, dr, dc):
        """The shard dr rows and dc columns from shard k, or None."""
        r, c = divmod(k, self.cols)
        r, c = r + dr, c + dc
        if 0 <= r < self.rows and 0 <= c < self.cols:
            return r * self.cols + c
        return None

    # -- placement -----------------------------------------------------

    def side(self, dev):
        """The exchange stream of CUDA device ``dev``."""
        key = torch.device(dev.type, dev.index or 0)
        if key not in self._side:
            self._side[key] = torch.cuda.Stream(device=key)
        return self._side[key]

    def record(self):
        """An event on each local shard's current stream (None on the
        CPU)."""
        if not self.on_cuda:
            return None
        events = [None] * self.n
        for k in self.mine:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.devices[k]))
            events[k] = ev
        return events

    def put(self, x, k):
        """numpy array or tensor ``x`` on shard k's device."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(self.devices[k], non_blocking=True)

    def each(self, x):
        """``x`` on every local shard's device (None elsewhere)."""
        return [self.put(x, k) if self.is_local(k) else None
                for k in range(self.n)]

    def split(self, x, rows, rows_pad, cols=None, cols_pad=None):
        """The leading axis of ``x`` (``rows`` long) padded with zeros to
        ``rows_pad`` and cut into one chunk per shard row, and on a grid of
        several columns its second axis (``cols`` long) padded to
        ``cols_pad`` and cut per shard column: per shard its chunk on its
        device (None at the other ranks' shards)."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        assert t.shape[0] == rows, (tuple(t.shape), rows)
        pad = [(0, rows_pad - rows)]
        if self.cols > 1:
            assert cols is not None and t.shape[1] == cols
            pad.append((0, cols_pad - cols))
        if any(p for _, p in pad):
            flat = []
            for lo_hi in reversed(pad + [(0, 0)] * (t.dim() - len(pad))):
                flat.extend(lo_hi)
            t = torch.nn.functional.pad(t, flat)
        out = [None] * self.n
        for k in self.mine:
            r, c = self.pos(k)
            chunk = t.chunk(self.rows)[r]
            if self.cols > 1:
                chunk = chunk.chunk(self.cols, dim=1)[c]
            out[k] = self.put(chunk.contiguous(), k)
        return out

    def _all(self, parts):
        """Every shard's part, on the first local device: the parts
        themselves in one process; gathered from every rank in a
        multi-process job (all parts have one shape)."""
        if self.group is None:
            return parts
        import torch.distributed as dist
        mine = torch.stack([parts[k].to(self.first) for k in self.mine])
        dtype = mine.dtype
        # int32 on the wire: gloo gathers no int16
        wire = mine.to(I32)
        if self.on_cuda and not self.nccl():
            wire = wire.cpu()
        got = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(got, wire, group=self.group)
        return [t.to(self.first).to(dtype) for g in got for t in g.unbind(0)]

    def gather(self, parts, dim=0):
        """The row flow's per-shard tensors concatenated along ``dim`` on
        the first local device."""
        assert self.cols == 1
        parts = self._all(parts)
        return torch.cat([p.to(self.first, non_blocking=True)
                          for p in parts], dim)

    def gather_grid(self, parts):
        """Per-shard [h, w, ...] tensors put together as the grid's rows x
        columns -> [rows * h, cols * w, ...] on the first local device."""
        parts = [p.to(self.first, non_blocking=True) for p in
                 self._all(parts)]
        rows = [parts[r * self.cols:(r + 1) * self.cols]
                for r in range(self.rows)]
        return torch.cat([row[0] if len(row) == 1 else torch.cat(row, dim=1)
                          for row in rows])

    def any(self, flags):
        """The OR of per-shard bool scalars (the JAX package's pmax), as a
        copy on each local shard's device."""
        tot = None
        for k in self.mine:
            f = flags[k].to(self.first, non_blocking=True)
            tot = f if tot is None else tot | f
        if self.group is not None:
            import torch.distributed as dist
            v = tot.to(I32)
            if self.on_cuda and not self.nccl():
                v = v.cpu()
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
            tot = v.to(self.first) != 0
        tot = tot.reshape(())
        return [tot.to(self.devices[k], non_blocking=True)
                if self.is_local(k) else None for k in range(self.n)]

    def nccl(self):
        if self.group is None:
            return False
        import torch.distributed as dist
        return dist.get_backend(self.group) == "nccl"

    # -- the exchange --------------------------------------------------

    def exchange(self, bufs, phases, ready=None):
        """Run phases of copies between the shards' buffers, phase after
        phase.  A copy is (kd, ks, dst_of, src_of): ``dst_of(bufs[kd])``,
        a view of shard kd's buffer, receives ``src_of(bufs[ks])``.  Each
        rank runs the copies into its own shards; a copy between ranks
        goes point to point (under gloo through host buffers, pinned when
        the shards are on the card; under NCCL card to card).

        On the card the copies into shard k run on its device's exchange
        stream once ``ready`` (events of every local shard's current
        stream, recorded when its buffer was final; recorded now when
        None) has passed on k and on the shards it reads, and each phase
        after the previous phase's copies into those shards; each shard's
        current stream then waits for the copies into it and out of it,
        so nothing waits on the host in one process.  The copies run
        inside a profiler range, "jpegqs_exchange"."""
        if self.on_cuda and ready is None:
            ready = self.record()
        ev = ready
        readers = {k: {k} for k in self.mine}
        with torch.profiler.record_function("jpegqs_exchange"):
            for copies in phases:
                local = {k: [] for k in self.mine}
                incoming = {k: [] for k in self.mine}
                remote = []
                for tag, (kd, ks, dst_of, src_of) in enumerate(copies):
                    ld, ls = self.is_local(kd), self.is_local(ks)
                    if ld and ls:
                        local[kd].append((dst_of(bufs[kd]), src_of(bufs[ks]),
                                          ks))
                        readers[ks].add(kd)
                    elif ls:
                        remote.append(("send", tag, kd, ks,
                                       src_of(bufs[ks])))
                    elif ld:
                        dst = dst_of(bufs[kd])
                        remote.append(("recv", tag, kd, ks, dst))
                if remote:
                    self._p2p(remote, ev, incoming)
                ev = self._run_local(local, incoming, ev)
        if not self.on_cuda:
            return
        for k in self.mine:
            cur = torch.cuda.current_stream(self.devices[k])
            for j in readers[k]:
                cur.wait_event(ev[j])

    def _run_local(self, local, incoming, ev):
        """The copies into each local shard: its own shards' and, already
        received, the other ranks' lines.  Returns the events of their
        end."""
        if not self.on_cuda:
            for k in self.mine:
                for dst, src, _ in local[k]:
                    dst.copy_(src)
                for dst, buf in incoming[k]:
                    dst.copy_(buf)
            return None
        done = [None] * self.n
        for k in self.mine:
            side = self.side(self.devices[k])
            side.wait_event(ev[k])
            for _, _, ks in local[k]:
                side.wait_event(ev[ks])
            for dst, src, _ in local[k]:
                _copy_on(self, dst, src)
            with torch.cuda.stream(side):
                for dst, buf in incoming[k]:
                    dst.copy_(buf, non_blocking=True)
            done[k] = torch.cuda.Event()
            done[k].record(side)
        return done

    def _p2p(self, remote, ev, incoming):
        """The copies between ranks of one phase, point to point; received
        lines land in ``incoming`` for _run_local."""
        import time
        import torch.distributed as dist
        nccl = self.nccl()
        ops, recvs = [], []
        t0 = time.perf_counter()
        ctx = (torch.cuda.stream(self.side(self.first)) if nccl
               else contextlib.nullcontext())
        with ctx:
            if nccl:
                for k in self.mine:
                    torch.cuda.current_stream().wait_event(ev[k])
            for what, tag, kd, ks, view in remote:
                if what == "send":
                    peer = self.owner(kd)
                    if self.on_cuda and not nccl:
                        ev[ks].synchronize()
                        buf = torch.empty(view.shape, dtype=view.dtype,
                                          pin_memory=True)
                        buf.copy_(view)
                    else:
                        buf = view.contiguous()
                    ops.append(dist.P2POp(dist.isend, buf, peer, self.group,
                                          tag))
                    P2P["bytes"] += buf.numel() * buf.element_size()
                else:
                    peer = self.owner(ks)
                    on_host = self.on_cuda and not nccl
                    buf = torch.empty(view.shape, dtype=view.dtype,
                                      pin_memory=on_host,
                                      device="cpu" if on_host
                                      else view.device)
                    ops.append(dist.P2POp(dist.irecv, buf, peer, self.group,
                                          tag))
                    recvs.append((kd, view, buf))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        P2P["calls"] += 1
        P2P["seconds"] += time.perf_counter() - t0
        for kd, view, buf in recvs:
            incoming[kd].append((view, buf))


def _copy_on(shards, dst, src):
    """dst.copy_(src) on the exchange streams of both devices."""
    with contextlib.ExitStack() as stack:
        for dev in {dst.device, src.device}:
            stack.enter_context(torch.cuda.stream(shards.side(dev)))
        dst.copy_(src, non_blocking=True)


def _as_shards(devices):
    return devices if isinstance(devices, Shards) else Shards(devices)


# ---------------------------------------------------------------------------
# The 1-pixel halo across shards for the colour glue (one exchange per
# component, outside the niter loop)
# ---------------------------------------------------------------------------

def blocks_halo10_sharded(pixs, hb_loc, wb_loc, row_edge, col_edge,
                          shards):
    """Sharded counterpart of planar.blocks_halo10 (the JAX package's
    blocks_halo10_sharded and blocks_halo10_sharded2d): per shard the
    [10, 10, hb_loc*wb_loc] block neighbourhoods, the cross-shard lines
    exchanged.  The rows go first; then the edge columns of the
    row-extended arrays go across, so a horizontal neighbour's column
    carries its own exchanged top / bottom lines -- the diagonal shard's
    corner pixels, as in the single-device version.  At the image's edges
    the lines replicate: the top / left on the first shard row / column,
    the bottom on the shard row ``row_edge`` = (shard row, local row) of
    the last REAL block row (the JAX _fix_dn_edge, before the horizontal
    gather so the corners stay right) and the right at ``col_edge`` (None
    on the row flow).  pixs: per shard int32[8, 8, hb_loc*wb_loc]."""
    er, el = row_edge

    def line(own, fed):
        """The shard's own line, replicated at an image edge, or a buffer
        that the exchange fills with a neighbour's."""
        return torch.empty_like(own) if fed else own

    st = [None] * shards.n
    for k in shards.mine:
        p4 = pixs[k].reshape(8, 8, hb_loc, wb_loc)
        st[k] = {"p4": p4,
                 "above": line(p4[0, :, 0, :],
                               shards.nb(k, -1, 0) is not None),
                 "below": line(p4[7, :, -1, :],
                               shards.nb(k, 1, 0) is not None)}
    copies = []
    for k in range(shards.n):
        up, dn = shards.nb(k, -1, 0), shards.nb(k, 1, 0)
        if up is not None:
            copies.append((k, up, lambda b: b["above"],
                           lambda b: b["p4"][7, :, -1, :]))
        if dn is not None:
            copies.append((k, dn, lambda b: b["below"],
                           lambda b: b["p4"][0, :, 0, :]))
    shards.exchange(st, [copies])
    mids = [None] * shards.n
    for k in shards.mine:
        p4, r = st[k]["p4"], shards.pos(k)[0]
        up = torch.cat([st[k]["above"][None, :, None, :], p4[7:8, :, :-1, :]],
                       dim=2)
        dn = torch.cat([p4[0:1, :, 1:, :], st[k]["below"][None, :, None, :]],
                       dim=2)
        if r == er:
            # the last REAL block row's bottom line is its own pixel row
            # 7, not the dead pad row below it
            dn[0, :, el, :] = p4[7, :, el, :]
        mid = torch.cat([up, p4, dn])                  # [10, 8, hb, wb]
        mids[k] = {"mid": mid,
                   "left": line(mid[:, 0, :, 0],
                                shards.nb(k, 0, -1) is not None),
                   "right": line(mid[:, 7, :, -1],
                                 shards.nb(k, 0, 1) is not None)}
    copies = []
    for k in range(shards.n):
        lf, rt = shards.nb(k, 0, -1), shards.nb(k, 0, 1)
        if lf is not None:
            copies.append((k, lf, lambda b: b["left"],
                           lambda b: b["mid"][:, 7, :, -1]))
        if rt is not None:
            copies.append((k, rt, lambda b: b["right"],
                           lambda b: b["mid"][:, 0, :, 0]))
    if copies:
        shards.exchange(mids, [copies])
    halos = [None] * shards.n
    for k in shards.mine:
        mid, c = mids[k]["mid"], shards.pos(k)[1]
        left = torch.cat([mids[k]["left"][:, None, :, None],
                          mid[:, 7:8, :, :-1]], dim=3)
        right = torch.cat([mid[:, 0:1, :, 1:],
                           mids[k]["right"][:, None, :, None]], dim=3)
        if col_edge is not None and c == col_edge[0]:
            right[:, 0, :, col_edge[1]] = mid[:, 7, :, col_edge[1]]
        halos[k] = torch.cat([left, mid, right], dim=1).reshape(
            10, 10, hb_loc * wb_loc)
    return halos


# ---------------------------------------------------------------------------
# The resident loop on ghost-extended shards
# ---------------------------------------------------------------------------

def _exchange_ghosts(pix, hb_loc, wb_loc, shards, ready=None):
    """Copy the boundary pixel lines into the ghost blocks of each shard's
    pixels pix[k] int32[64, (hb_loc+2) * wb_eff] (wb_eff = wb_loc, or
    wb_loc + 2 with ghost columns on a grid of several columns): first the
    top ghost row's real columns receive pixel rows 56..63 of the upper
    shard's last row, the bottom ghost row's pixel rows 0..7 of the lower
    shard's first; then, on a grid, the left ghost column receives pixel
    column 7 of the left shard's last real column and the right ghost
    column pixel column 0 of the right shard's first, in every row of the
    row-extended grids, ghost rows included: the corners are the diagonal
    shards' (the JAX package's _exchange_ghosts2d).  Edge shards keep their
    ghosts: no edge flag lets a kernel read them.  The copies go through
    ``shards.exchange`` (side streams and events on the card)."""
    gc = 1 if shards.cols > 1 else 0
    wb_eff = wb_loc + 2 * gc
    last, bot = hb_loc * wb_eff, (hb_loc + 1) * wb_eff
    rows = []
    for k in range(shards.n):
        up, dn = shards.nb(k, -1, 0), shards.nb(k, 1, 0)
        if up is not None:
            rows.append((k, up, lambda p: p[56:64, gc:gc + wb_loc],
                         lambda p: p[56:64, last + gc:last + gc + wb_loc]))
        if dn is not None:
            rows.append((k, dn, lambda p: p[0:8, bot + gc:bot + gc + wb_loc],
                         lambda p: p[0:8, wb_eff + gc:wb_eff + gc + wb_loc]))
    phases = [rows]
    if gc:
        def col(p, c, x):
            """Pixel column c of grid column x, every row: [8, hb_loc+2]."""
            return p.view(64, hb_loc + 2, wb_eff)[c::8, :, x]
        cols = []
        for k in range(shards.n):
            lf, rt = shards.nb(k, 0, -1), shards.nb(k, 0, 1)
            if lf is not None:
                cols.append((k, lf, lambda p: col(p, 7, 0),
                             lambda p: col(p, 7, wb_loc)))
            if rt is not None:
                cols.append((k, rt, lambda p: col(p, 0, wb_eff - 1),
                             lambda p: col(p, 0, 1)))
        phases.append(cols)
    if shards.n > 1:
        shards.exchange(pix, phases, ready)


def _sharded_resident_iters(coefs, img2_halos, tabs, flags, luma, hb_loc,
                            wb_loc, niter, extra_refresh, shards, row_edge,
                            col_edge):
    """The sharded loop on resident planes: per shard the B1 bootstrap,
    then ``niter`` x (ghost exchange, B7 over the shard's real blocks).

    coefs: per shard the dequantized coefficients int32[64, B] (B =
    hb_loc*wb_loc); img2_halos: per shard int32[100, B] (JOINT_YUV
    preamble) or None; tabs: per shard (div, x1, qshr).  Returns per shard
    (coef', pix'), pix' the pixels of the last pass that emitted them (the
    bootstrap when none did).  Ghost blocks are never computed, nor the
    dead pad blocks past the image's bottom and right edges: on the row
    flow one B7 launch covers a shard's real rows, on a grid of several
    columns each real row is one launch over its real columns (a range
    holds no ghost-column block, so the kernel needs no mask for them)."""
    B = hb_loc * wb_loc
    gc = 1 if shards.cols > 1 else 0
    wb_eff = wb_loc + 2 * gc
    er, el = row_edge
    ecr, ecl = col_edge
    do_reb = engine._do_rebalance(flags, luma)

    def embed(x):              # [R, B] -> [R, (hb_loc+2) * wb_eff]
        g = torch.nn.functional.pad(x.reshape(-1, hb_loc, wb_loc),
                                    (gc, gc, 1, 1))
        return g.reshape(x.shape[0], -1)

    def extract(x):
        g = x.view(x.shape[0], hb_loc + 2, wb_eff)
        return g[:, 1:-1, gc:gc + wb_loc].reshape(x.shape[0], B)

    n, mine = shards.n, shards.mine
    coef_a, coef_b, pix_a, pix_b, img2 = ([None] * n for _ in range(5))
    rows, ncols, edges = [0] * n, [0] * n, [None] * n
    for k in mine:
        r, c = shards.pos(k)
        coef_a[k] = embed(coefs[k])
        coef_b[k] = torch.zeros_like(coef_a[k])
        # the ghosts' pixels stay as the bootstrap left them until the
        # exchange overwrites the lines a kernel reads
        pix_a[k] = cuda_solver.idct_pix(coef_a[k])
        pix_b[k] = torch.zeros_like(pix_a[k])
        img2[k] = None if img2_halos[k] is None else embed(img2_halos[k])
        rows[k] = hb_loc if r < er else (el + 1 if r == er else 0)
        ncols[k] = wb_loc if c < ecr else (ecl + 1 if c == ecr else 0)
        edges[k] = (1 if r == 0 else -1, el + 1 if r == er else -1,
                    gc if c == 0 else -1, ecl + gc if c == ecr else -1)
    # with the split (row flow), rows 2 .. rows-1 read no ghost line: they
    # go before the exchange, rows 1 and ``rows`` after it
    overlap = not gc and _overlap_enabled()
    split = [overlap and rows[k] >= 3 for k in range(n)]

    def run(k, row0, row1, keep):
        if gc:      # one range per row, its real columns
            spans = [(i * wb_eff + gc, i * wb_eff + gc + ncols[k])
                     for i in range(row0, row1)] if ncols[k] else []
        else:
            spans = [(row0 * wb_eff, row1 * wb_eff)]
        for b0, b1 in spans:
            cuda_solver.solve_range_pix(
                coef_a[k], pix_a[k], img2[k], *tabs[k], flags, do_reb,
                wb_eff, b0, b1, edges[k], coef_b[k],
                pix_b[k] if keep else None)

    for it in range(niter):
        keep = it < niter - 1 or bool(extra_refresh)
        ready = shards.record()
        for k in mine:
            if split[k]:
                run(k, 2, rows[k], keep)
        _exchange_ghosts(pix_a, hb_loc, wb_loc, shards, ready)
        for k in mine:
            if split[k]:
                run(k, 1, 2, keep)
                run(k, rows[k], rows[k] + 1, keep)
            elif rows[k]:
                run(k, 1, rows[k] + 1, keep)
        coef_a, coef_b = coef_b, coef_a
        if keep:
            pix_a, pix_b = pix_b, pix_a
    return ([None if c is None else extract(c) for c in coef_a],
            [None if p is None else extract(p) for p in pix_a])


def _component_body(coef16s, tabs, img2_halos, *, hb_loc, wb_loc, flags,
                    niter, extra_refresh, luma, shards, row_edge, col_edge):
    """One component on its shards (the JAX package's _component_body):
    the dequantization with the crafted-file guard ORed over the shards
    (quantsmooth.h:2596-2610), the resident loop, the guard's fallback and
    the +-1023 clamp.  coef16s: per shard int16[hb_loc*wb_loc, 64]; tabs:
    per shard (qraw, div, x1, qshr).  Returns per shard the coefficients
    int32[64, B], the pixels int32[64, B] and the OR of the guard."""
    n = shards.n
    deq = [None] * n
    for k in shards.mine:
        deq[k] = engine.dequant(coef16s[k], tabs[k][0])
    badv = shards.any([None if d is None else d[1] for d in deq])
    coefs, pixs = _sharded_resident_iters(
        [None if d is None else d[0] for d in deq], img2_halos,
        [None if t is None else t[1:] for t in tabs], flags, luma, hb_loc,
        wb_loc, niter, extra_refresh, shards, row_edge, col_edge)
    outs = [None] * n
    for k in shards.mine:
        outs[k] = torch.clamp(torch.where(badv[k], deq[k][0], coefs[k]),
                              -1023, 1023)
    return outs, pixs, badv


def _tables(shards, qtabs):
    """(qraw, div, x1, qshr) on each local shard's device."""
    per = [shards.each(t) for t in qtabs]
    return [tuple(p[k] for p in per) if shards.is_local(k) else None
            for k in range(shards.n)]


def _grid_dims(shards, hb, wb):
    """(hb_pad, wb_pad, hb_loc, wb_loc, row_edge, col_edge) of an hb x wb
    block plane on the shards' grid (pad-to-divisible on both axes)."""
    assert hb >= shards.rows and wb >= shards.cols, \
        "more shards than block rows / columns"
    hb_pad, wb_pad = _pad_to(hb, shards.rows), _pad_to(wb, shards.cols)
    hb_loc, wb_loc = hb_pad // shards.rows, wb_pad // shards.cols
    return (hb_pad, wb_pad, hb_loc, wb_loc, _edge_pos(hb, hb_loc),
            _edge_pos(wb, wb_loc))


def make_sharded_smooth(devices, *, hb, wb, flags, niter, extra_refresh=0,
                        luma=True, use_image2=False, want_pix=False,
                        batch=False):
    """A sharded component smoother over ``devices``: a flat list (one
    shard per block-row band), a list of rows of devices (a rows x columns
    grid), or a ``Shards``; a device may repeat.

    Returns fn(coef16, qraw, div, x1, qshr[, image2]) -> (coef int16[hb,
    wb, 64], badv bool[, pix int32[8, 8, hb*wb]]) on the first device.
    coef16 int16[hb, wb, 64] and the int32[64] tables may be numpy arrays
    or tensors.  Block rows and columns that do not divide the grid are
    padded with dead zero blocks (no edge of theirs is read; they are cut
    from the result), so any plane uses every device.  With use_image2
    (JOINT_YUV chroma pass) image2 is the downsampled luma plane's
    interior int32[hb*8, wb*8]; its halos are exchanged like the plane's.
    ``want_pix``: also the final pixels (needs ``extra_refresh``; row flow
    only, as in the JAX package).

    ``batch=True`` (the JAX package's ``batch_axis``): ``devices`` is a
    list of groups, each a layout as above (a data x row layout when each
    group is a flat list), and fn takes coef16 int16[N, hb, wb, 64] (and
    image2 [N, hb*8, wb*8]) and returns (int16[N, hb, wb, 64], badv
    bool[N]): the N images are cut into one contiguous share per group,
    and each group smooths its share image by image over its own devices,
    with no traffic between groups."""
    kw = dict(hb=hb, wb=wb, flags=flags, niter=niter,
              extra_refresh=extra_refresh, luma=luma, use_image2=use_image2)
    if batch:
        assert not want_pix, "want_pix is a single-image hook"
        return _batch_form([make_sharded_smooth(g, **kw) for g in devices])
    shards = _as_shards(devices)
    hb_pad, wb_pad, hb_loc, wb_loc, row_edge, col_edge = _grid_dims(
        shards, hb, wb)
    assert not (want_pix and shards.cols > 1), \
        "want_pix is a row-flow hook (flat block axis)"
    B = hb_loc * wb_loc
    img2_live = use_image2 and bool(flags & JOINT_YUV)
    n = shards.n

    def run(coef16, qraw, div, x1, qshr, image2=None):
        coefs = [None if c is None else c.reshape(B, 64) for c in
                 shards.split(coef16.reshape(hb, wb, 64), hb, hb_pad, wb,
                              wb_pad)]
        img2 = [None] * n
        if img2_live:
            planes = shards.split(image2, hb * 8, hb_pad * 8, wb * 8,
                                  wb_pad * 8)
            ds = [None if p is None else
                  planar.plane_to_fblocks_p(p, hb_loc, wb_loc).to(I32)
                  for p in planes]
            halos = blocks_halo10_sharded(
                ds, hb_loc, wb_loc, row_edge,
                col_edge if shards.cols > 1 else None, shards)
            img2 = [None if h is None else h.reshape(100, B) for h in halos]
        outs, pixs, badv = _component_body(
            coefs, _tables(shards, (qraw, div, x1, qshr)), img2,
            hb_loc=hb_loc, wb_loc=wb_loc, flags=flags, niter=niter,
            extra_refresh=extra_refresh, luma=luma, shards=shards,
            row_edge=row_edge, col_edge=col_edge)
        out = shards.gather_grid([
            None if o is None else o.T.to(I16).reshape(hb_loc, wb_loc, 64)
            for o in outs])[:hb, :wb].contiguous()
        bad = badv[shards.mine[0]]
        if want_pix:
            pix = shards.gather(pixs, dim=1).reshape(8, 8, -1)[..., :hb * wb]
            return out, bad, pix
        return out, bad

    run.padded_dims = (hb_pad, wb_pad)
    return run


def _batch_form(groups):
    """fn(coef16[N, ...], tables[, image2[N, ...]]) over the per-group
    smoothers ``groups``: contiguous shares of the N images, one per group
    (as the JAX package's ``batch_axis`` splits them), each share image by
    image through its group's smoother; the results stacked on the first
    group's first device."""
    def run(coef16, qraw, div, x1, qshr, image2=None):
        shares = np.array_split(np.arange(coef16.shape[0]), len(groups))
        outs, bads = [], []
        for fn, share in zip(groups, shares):
            for i in share:
                res = fn(coef16[i], qraw, div, x1, qshr,
                         None if image2 is None else image2[i])
                outs.append(res[0])
                bads.append(res[1])
        dev = outs[0].device
        return (torch.stack([o.to(dev, non_blocking=True) for o in outs]),
                torch.stack([b.to(dev, non_blocking=True) for b in bads]))

    run.padded_dims = groups[0].padded_dims
    return run


def make_sharded_ycbcr_smooth(devices, *, hb_l, wb_l, hb_c, wb_c, ws, hs,
                              flags, niter, img_w=None, img_h=None):
    """Sharded YCbCr smoothing, the reference flow quantsmooth.h:2484-2849
    with UPSAMPLE_UV, over ``devices`` (a flat list, a list of rows of
    devices, or a ``Shards``).

    The three planes are sharded alike: the luma pass emits its pixels,
    which are box-downsampled shard by shard and halo-exchanged into the
    chroma JOINT_YUV passes; UPSAMPLE_UV regresses the full-resolution
    chroma shard by shard from the luma pixels.  Needs aligned dims (hb_l
    == hs*hb_c, wb_l == ws*wb_c), ws, hs in {1, 2}.  Chroma block rows
    (columns) are padded to a multiple of the grid's rows (columns), the
    luma's to hs (ws) times that; a grid of several columns needs >= 2
    local luma block columns when UPSAMPLE_UV runs, so that the right
    tail's source column stays in its shard.  Returns fn(coef_y, coef_cb,
    coef_cr, qtabs_y, qtabs_c[, qtabs_cr]) -> (y, cb, cr, badv, ups): int16
    planes [hb, wb, 64] on the first device, ups None or (up_cb, up_cr)
    int16[hb_l, wb_l, 64]; qtabs_* are (qraw, div, x1, qshr) int32[64],
    Cr's defaulting to Cb's."""
    assert ws in (1, 2) and hs in (1, 2)
    assert hb_l == hs * hb_c and wb_l == ws * wb_c, "aligned dims only"
    shards = _as_shards(devices)
    hb_c_pad, wb_c_pad, hbc_loc, wbc_loc, edge_c, cedge_c = _grid_dims(
        shards, hb_c, wb_c)
    hb_l_pad, wb_l_pad = hs * hb_c_pad, ws * wb_c_pad
    hbl_loc, wbl_loc = hs * hbc_loc, ws * wbc_loc
    Bl, Bc = hbl_loc * wbl_loc, hbc_loc * wbc_loc
    edge_l, cedge_l = _edge_pos(hb_l, hbl_loc), _edge_pos(wb_l, wbl_loc)
    grid = shards.cols > 1
    img_w = wb_l * 8 if img_w is None else img_w
    img_h = hb_l * 8 if img_h is None else img_h
    do_up = bool(flags & UPSAMPLE_UV) and not (ws == 1 and hs == 1)
    assert not (grid and do_up and wbl_loc < 2), \
        "column-sharded UPSAMPLE needs >= 2 local luma block columns"
    n, mine = shards.n, shards.mine

    def body(coefs, tabs, img2, hb_loc, wb_loc, extra, luma, edge, cedge):
        return _component_body(coefs, tabs, img2, hb_loc=hb_loc,
                               wb_loc=wb_loc, flags=flags, niter=niter,
                               extra_refresh=extra, luma=luma, shards=shards,
                               row_edge=edge, col_edge=cedge)

    def halo_c(pixs):
        return blocks_halo10_sharded(
            [None if p is None else p.reshape(8, 8, Bc) for p in pixs],
            hbc_loc, wbc_loc, edge_c, cedge_c if grid else None, shards)

    def upsample(pix_c, img2_halo, pix_y):
        """UPSAMPLE_UV of one chroma component, shard by shard (both
        replicate tails stay inside one shard)."""
        ch_halo = halo_c(pix_c)
        parts = [None] * n
        for k in mine:
            r, c = shards.pos(k)
            parts[k] = cuda_solver.upsample_fdct_blocks(
                ch_halo[k].reshape(100, Bc), img2_halo[k].reshape(100, Bc),
                pix_y[k].reshape(64, Bl), img_w, img_h, ws, hs, hbl_loc,
                wbl_loc, hbc_loc, wbc_loc, row0=r * hbl_loc * 8,
                hb_l_total=hb_l, col0=c * wbl_loc * 8,
                wb_l_total=wb_l).reshape(hbl_loc, wbl_loc, 64)
        return shards.gather_grid(parts)[:hb_l, :wb_l].contiguous()

    def run(coef_y, coef_cb, coef_cr, qtabs_y, qtabs_c, qtabs_cr=None):
        if qtabs_cr is None:
            qtabs_cr = qtabs_c
        cy = [None if c is None else c.reshape(Bl, 64) for c in shards.split(
            coef_y.reshape(hb_l, wb_l, 64), hb_l, hb_l_pad, wb_l, wb_l_pad)]
        ccb, ccr = ([None if c is None else c.reshape(Bc, 64)
                     for c in shards.split(x.reshape(hb_c, wb_c, 64), hb_c,
                                           hb_c_pad, wb_c, wb_c_pad)]
                    for x in (coef_cb, coef_cr))
        ty, tcb, tcr = (_tables(shards, q) for q in (qtabs_y, qtabs_c,
                                                     qtabs_cr))
        # the plain-dequantized planes a tripped guard falls back to
        dq = [[None if c is None else engine.dequant_only(c, t[0])
               for c, t in zip(cs, ts)]
              for cs, ts in ((cy, ty), (ccb, tcb), (ccr, tcr))]

        y, pix_y, bad_y = body(cy, ty, [None] * n, hbl_loc, wbl_loc, 1, True,
                               edge_l, cedge_l)
        img2_halo = None
        if flags & JOINT_YUV or do_up:
            ds = [None] * n
            for k in mine:
                ds[k] = planar.downsample_blocks(
                    pix_y[k].reshape(8, 8, Bl), hbl_loc, wbl_loc, hbc_loc,
                    wbc_loc, ws, hs)
            img2_halo = halo_c(ds)
        joint = ([None if h is None else h.reshape(100, Bc)
                  for h in img2_halo] if flags & JOINT_YUV else [None] * n)
        extra_c = 1 if do_up else 0
        cb, pix_cb, bad_cb = body(ccb, tcb, joint, hbc_loc, wbc_loc, extra_c,
                                  False, edge_c, cedge_c)
        cr, pix_cr, bad_cr = body(ccr, tcr, joint, hbc_loc, wbc_loc, extra_c,
                                  False, edge_c, cedge_c)

        # stop propagation (engine.run_image): once a component trips the
        # guard, the later ones come out plain-dequantized
        planes = []
        stop = [None] * n
        for k in mine:
            stop[k] = torch.zeros((), dtype=torch.bool,
                                  device=shards.devices[k])
        for res, bad, d, h, w in ((y, bad_y, dq[0], hbl_loc, wbl_loc),
                                  (cb, bad_cb, dq[1], hbc_loc, wbc_loc),
                                  (cr, bad_cr, dq[2], hbc_loc, wbc_loc)):
            parts = [None] * n
            for k in mine:
                parts[k] = torch.where(stop[k], d[k],
                                       res[k].T.to(I16)).reshape(h, w, 64)
                stop[k] = stop[k] | bad[k]
            planes.append(shards.gather_grid(parts))
        oy = planes[0][:hb_l, :wb_l].contiguous()
        ocb, ocr = (p[:hb_c, :wb_c].contiguous() for p in planes[1:])
        ups = None
        if do_up:
            ups = (upsample(pix_cb, img2_halo, pix_y),
                   upsample(pix_cr, img2_halo, pix_y))
        return oy, ocb, ocr, stop[mine[0]], ups

    run.padded_dims = (hb_l_pad, wb_l_pad, hb_c_pad, wb_c_pad)
    return run


# ---------------------------------------------------------------------------
# Whole images over a data x row layout, and the dry run
# ---------------------------------------------------------------------------

def smooth_batch_sharded(imgs, opts, groups):
    """Smooth decoded images over a data x row layout of devices: the
    images are cut into one contiguous share per group (``groups``: a list
    of device lists), and each group smooths its share on its own devices
    with no traffic between groups: a group of one device through the
    batch engine (batch.dispatch_image_batch: one whole-image run of its
    share, queued, so the next group's work is queued before this one's
    results are fetched), a group of several through the engine's
    auto-sharding of each image over its devices
    (engine._try_smooth_sharded, or one device where that declines, as
    smooth() does).  Returns a list of engine.SmoothResult in input order,
    bit-identical to batch.smooth_image_batch on one device."""
    from .. import batch

    shares = np.array_split(np.arange(len(imgs)), len(groups))
    pending = []
    for group, share in zip(groups, shares):
        share = [imgs[i] for i in share]
        if not share:
            continue
        if len(group) == 1:
            pending.append(batch.dispatch_image_batch(
                share, opts, engine.resolve_device(group[0])))
            continue
        devs = [engine.resolve_device(d) for d in group]
        out = []
        for im in share:
            res = engine._try_smooth_sharded(im, opts, devs)
            out.append(res if res is not None
                       else engine._smooth_fused(im, opts, devs[0]))
        pending.append(lambda out=out: out)
    return [res for assemble in pending for res in assemble()]


def _example_component(hb, wb, seed):
    """__graft_entry__._example_component: quantized coefficients inside
    the crafted-file guard and an annex-K-like luminance table scaled to
    quality ~70 -> (coef16 int16[hb*wb, 64], qraw, div, x1, qshr)."""
    from ..ops.quant import make_quant_tables
    rng = np.random.default_rng(seed)
    qtbl = np.clip((np.array([
        16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
        99]) * 0.6).astype(np.int32), 1, 255)
    cap = 2047 // qtbl
    coef16 = (rng.integers(-60, 61, (hb * wb, 64))
              // (1 + np.arange(64) // 8))
    coef16 = np.clip(coef16, -cap[None, :], cap[None, :]).astype(np.int16)
    return (coef16, qtbl.astype(np.int32), *make_quant_tables(qtbl))


def _data_row(n_devices):
    """__graft_entry__.dryrun_multichip's factoring of n devices into
    (data, row): the row axis grows by prime factors of the remaining
    quotient up to 4 (or n / 2), the data axis takes the rest."""
    n_row, rem = 1, n_devices
    for f in (2, 3, 5, 7):
        while rem % f == 0 and n_row * f <= max(2, n_devices // 2):
            n_row *= f
            rem //= f
            if n_row >= 4:
                break
        if n_row >= 4:
            break
    return max(n_devices // n_row, 1), n_row


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The port of ``__graft_entry__.dryrun_multichip``: one step of each
    sharded flow over ``n_devices`` shards -- on the cards of ``device``'s
    type in turn (the card unless ``device="cpu"``; with fewer cards than
    shards, shards of the same card):

    - the batch form of make_sharded_smooth over a (data, row) layout,
      n_devices factored as the JAX dry run factors it;
    - the YCbCr q6 flow (JOINT_YUV + UPSAMPLE_UV) row-sharded over all;
    - a (n/2, 2) rows x columns grid: a component, and the YCbCr q6 flow;
    - pad-to-divisible sharding of a prime block-row count.

    Checks the output shapes and returns the summary line."""
    dev = engine.resolve_device(device)
    if dev.type == "cuda":
        ncard = torch.cuda.device_count()
        devices = [torch.device("cuda", i % ncard) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    n_data, n_row = _data_row(n_devices)
    layout = [devices[g * n_row:(g + 1) * n_row] for g in range(n_data)]
    hb, wb, n_batch = 2 * n_row, 4, 2 * n_data
    coef16, *tabs = _example_component(hb, wb, 1)
    coef_b = np.broadcast_to(coef16.reshape(1, hb, wb, 64),
                             (n_batch, hb, wb, 64)).copy()
    fn = make_sharded_smooth(layout, hb=hb, wb=wb, flags=1, niter=2,
                             batch=True)
    out, _ = fn(coef_b, *tabs)
    assert tuple(out.shape) == (n_batch, hb, wb, 64)

    hb_c, wb_c = n_devices, 4
    hb_l, wb_l = 2 * hb_c, 2 * wb_c
    cy = _example_component(hb_l, wb_l, 2)[0].reshape(hb_l, wb_l, 64)
    cc = _example_component(hb_c, wb_c, 3)[0].reshape(hb_c, wb_c, 64)
    qtabs = _example_component(2, 2, 4)[1:]
    yfn = make_sharded_ycbcr_smooth(devices, hb_l=hb_l, wb_l=wb_l, hb_c=hb_c,
                                    wb_c=wb_c, ws=2, hs=2, flags=7, niter=1)
    _, _, _, _, ups = yfn(cy, cc, cc.copy(), qtabs, qtabs)
    assert ups is not None and tuple(ups[0].shape) == (hb_l, wb_l, 64)
    grid_note = "none"
    if n_devices >= 2:
        n_c = 2
        n_r = n_devices // n_c
        grid = [devices[r * n_c:(r + 1) * n_c] for r in range(n_r)]
        hb2, wb2 = 2 * n_r, 2 * n_c
        c2, *tabs2 = _example_component(hb2, wb2, 5)
        out2, _ = make_sharded_smooth(grid, hb=hb2, wb=wb2, flags=1,
                                      niter=1)(c2.reshape(hb2, wb2, 64),
                                               *tabs2)
        assert tuple(out2.shape) == (hb2, wb2, 64)
        hb_c2, wb_c2 = n_r, 2 * n_c
        cy2 = _example_component(2 * hb_c2, 2 * wb_c2, 6)[0].reshape(
            2 * hb_c2, 2 * wb_c2, 64)
        cc2 = _example_component(hb_c2, wb_c2, 7)[0].reshape(hb_c2, wb_c2,
                                                               64)
        yfn2 = make_sharded_ycbcr_smooth(
            grid, hb_l=2 * hb_c2, wb_l=2 * wb_c2, hb_c=hb_c2, wb_c=wb_c2,
            ws=2, hs=2, flags=7, niter=1)
        _, _, _, _, ups2 = yfn2(cy2, cc2, cc2.copy(), qtabs, qtabs)
        assert ups2 is not None and \
            tuple(ups2[0].shape) == (2 * hb_c2, 2 * wb_c2, 64)
        grid_note = f"{n_r}x{n_c}"
    hb_p = 13 if n_devices <= 13 else n_devices + 3
    cp, *tabs_p = _example_component(hb_p, 4, 8)
    outp, _ = make_sharded_smooth(devices, hb=hb_p, wb=4, flags=1,
                                  niter=1)(cp.reshape(hb_p, 4, 64), *tabs_p)
    assert tuple(outp.shape) == (hb_p, 4, 64)
    if dev.type == "cuda":
        for d in set(devices):
            torch.cuda.synchronize(d)
    return (f"dryrun_multichip OK: (data, row) = ({n_data}, {n_row}), "
            f"batch {n_batch}, plane {hb}x{wb} blocks; ycbcr q6 sharded "
            f"over {n_devices} shards (upsampled {hb_l}x{wb_l}); 2-D grid "
            f"{grid_note} ok; prime-rows pad-to-divisible ({hb_p} rows) ok")
