"""Multi-process execution over ``torch.distributed``: the port of
``jpegqs_tpu/parallel/multihost.py``.

The reference has no multi-machine story: OpenMP shared memory is its
whole parallel stack (quantsmooth.h:2552-2554).  The JAX package joins a
``jax.distributed`` job; here the processes join a ``torch.distributed``
process group (``initialize``: its address, world size and rank are given,
nothing is discovered), each rank bringing its own devices:

- ``smooth_jpeg_distributed``: ONE image sharded over every device of the
  job -- block rows first, a rows x columns grid when the rows cannot
  spread over every device (``_full_grid``) -- with the ghost lines
  between ranks sent point to point (``parallel/sharded.Shards``).  Every
  rank parses the same bytes and receives the whole result (all-gathered),
  so any rank can encode.
- ``smooth_batch_distributed``: per-rank batches on a (data, row) layout:
  data parallelism across ranks, no traffic between them, and each
  image row-sharded over the rank's own devices.

The backend is NCCL when every rank has its own card (each host's ranks
no more than its cards); NCCL refuses two ranks on one card, so when
ranks share a card, and on the CPU, it is gloo,
whose point-to-point copies take host tensors: ghost lines of shards on
the card then go through pinned host buffers.  ``initialize`` prints the
backend it joined with and never changes it behind the caller's back.

Bit-exactness: the compute path is parallel/sharded.py, bit-identical to
the single-device engine; tests/test_torch_multihost.py holds real
two-process gloo runs against jpegqs_tpu.engine.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import engine
from ..options import QsOptions, UPSAMPLE_UV
from ..ops.quant import make_quant_tables
from . import sharded


def pick_backend(device, local_world_size):
    """NCCL when every rank of this host has a card of its own (``device``
    CUDA and at least ``local_world_size`` cards here); gloo when ranks
    share a card or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= \
            local_world_size:
        return "nccl"
    return "gloo"


def rank_device(local_rank, device=None):
    """The device of a rank: the card (cuda:local_rank, or the one card
    the host's ranks share) unless ``device`` says otherwise
    (``"cpu"``)."""
    if device is not None:
        return engine.resolve_device(device)
    engine.resolve_device()
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _loopback(init_method):
    """Whether a ``tcp://host:port`` address is this machine's loopback
    (every rank of the job then runs here)."""
    host = init_method.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


_JOINED = {}


def initialize(init_method, world_size, rank, backend=None, device=None,
               local_rank=None, local_world_size=None):
    """Join (or start, at rank 0) a torch.distributed job: ``init_method``
    (``"tcp://host:port"``, or ``"host:port"``), the number of ranks and
    this one's, and this rank's place among the ranks of its host
    (``local_rank`` of ``local_world_size``; on a loopback address, where
    the whole job runs on this machine, they default to ``rank`` and
    ``world_size``).  ``backend`` None picks it (pick_backend) for this
    rank's ``device`` (rank_device); the choice is printed to stderr.
    Returns the backend."""
    import torch.distributed as dist

    if "://" not in init_method:
        init_method = "tcp://" + init_method
    if local_rank is None or local_world_size is None:
        if not _loopback(init_method):
            raise ValueError("a job across hosts needs local_rank and "
                             "local_world_size: the ranks on this host")
        local_rank, local_world_size = rank, world_size
    dev = rank_device(local_rank, device)
    if backend is None:
        backend = pick_backend(dev, local_world_size)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _JOINED["device"] = dev
    print(f"jpegqs_tpu_torch: rank {rank} of {world_size} joined, backend "
          f"{backend}, device {dev}", file=sys.stderr, flush=True)
    return backend


def _full_grid(hbs, wbs, ndev, wbl_for_up=None):
    """(rows, cols) factorization of ndev with rows <= the smallest
    component's block rows and cols <= its block columns, row-heavy first
    (the row flow's shards exchange the least), or None when the planes
    are smaller than any full-device grid.  Divisibility is not needed:
    pad-to-divisible sharding takes any row count (quantsmooth.h:2586-2588
    schedule(dynamic)).  ``wbl_for_up``: the luma block columns when the
    UPSAMPLE right tail's source must stay in its shard (>= 2 local luma
    block columns)."""
    for r in range(min(ndev, min(hbs)), 0, -1):
        if ndev % r:
            continue
        c = ndev // r
        if c > min(wbs):
            continue
        if c > 1 and wbl_for_up is not None and wbl_for_up // c < 2:
            continue
        return r, c
    return None


def _world():
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "multihost.initialize first")
    return dist.group.WORLD, dist.get_world_size()


def joined_device():
    """This rank's device, as ``initialize`` chose it."""
    if "device" not in _JOINED:
        raise RuntimeError("join the job through multihost.initialize, or "
                           "pass the devices")
    return _JOINED["device"]


def _local_devices(devices):
    if devices is None:
        return [joined_device()]
    return [torch.device(d) for d in devices]


def smooth_jpeg_distributed(data: bytes, opts: QsOptions = None,
                            devices=None):
    """Smooth one JPEG across every device of the job.  Every rank calls
    this with the same bytes and its own ``devices`` (a list, as many on
    every rank; default its device from ``initialize``); returns
    (SmoothResult, img) with the whole coefficient planes on every
    rank."""
    from ..host.jpegio import read_coefficients
    img = read_coefficients(data)
    return smooth_image_distributed(img, opts, devices), img


def smooth_image_distributed(img, opts: QsOptions = None, devices=None):
    """smooth_jpeg_distributed on a decoded image (every rank passes the
    same one): the planes sharded over the (rows, cols) grid of
    ``_full_grid`` over every rank's devices, rank after rank in row-major
    order, through the engine's sharded body (engine._smooth_on_shards).
    Raises where the image is smaller than any full-device grid, or where
    its YCbCr colour flow has planes that are not aligned."""
    if opts is None:
        opts = QsOptions.from_quality(3, 3)
    group, world = _world()
    devices = _local_devices(devices)
    comps = img.components
    up_live = (engine._need_downsample(img, opts.flags)
               and bool(opts.flags & UPSAMPLE_UV)
               and not (comps[0].h_samp_factor == 1
                        and comps[0].v_samp_factor == 1))
    ndev = world * len(devices)
    grid = _full_grid([c.height_in_blocks for c in comps],
                      [c.width_in_blocks for c in comps], ndev,
                      comps[0].width_in_blocks if up_live else None)
    if grid is None:
        raise ValueError(
            f"component block grids "
            f"{[(c.height_in_blocks, c.width_in_blocks) for c in comps]} "
            f"are smaller than any (rows, cols) factorization of {ndev} "
            f"devices; use engine.smooth (one process) for this image")
    res = engine._smooth_on_shards(
        img, opts, sharded.Shards(devices, cols=grid[1], group=group))
    if res is None:
        raise ValueError("the distributed YCbCr colour path needs aligned "
                         "plane dims and three components; use "
                         "engine.smooth (one process) for this image")
    return res


def smooth_batch_distributed(coefs_local, qtbl, flags, niter, luma=True,
                             devices=None):
    """Per-rank image batches on the (data, row) layout: each rank passes
    its LOCAL batch coefs int16[n_loc, hb, wb, 64] (one shape and quant
    table on every rank, the bucketed-corpus contract) and gets its own
    results int16[n_loc, hb, wb, 64] back, each image row-sharded over the
    rank's ``devices``; batch parallelism across ranks needs no gather."""
    _world()
    devices = _local_devices(devices)
    coefs_local = np.ascontiguousarray(coefs_local, np.int16)
    n_loc, hb, wb, _ = coefs_local.shape
    qraw = np.asarray(qtbl, np.int32)
    fn = sharded.make_sharded_smooth([devices], hb=hb, wb=wb, flags=flags,
                                     niter=niter, luma=luma, batch=True)
    out, _ = fn(coefs_local, qraw, *make_quant_tables(qraw))
    return out.cpu().numpy()
