#!/usr/bin/env python3
"""Ranks of a multi-process check or timing run of the port's
multi-process engine (jpegqs_tpu_torch/parallel/multihost.py), for the
tests and chip_smoke.py: the launcher's options
(jpegqs_tpu_torch.parallel.run_multihost) and its ``--local N`` fan-out,
plus a synthetic input, saved planes, a batch and repeated runs.  Run
from the repository root::

    python3 tools/multihost_worker.py --local 2 --shards-per-rank 2 \\
        [--device cpu] --synth H,W,COLOR,SEED [--reps N] --save out.npz \\
        [-q 6 -n 3]
    python3 tools/multihost_worker.py --local 2 ... --save out.npz \\
        in.jpg out.jpg
    python3 tools/multihost_worker.py --local 2 ... --synth H,W,0,SEED \\
        --batch N --save BASE

``--synth H,W,COLOR,SEED`` smooths a synthetic image (jpegqs_tpu_torch
/synth.py) with smooth_image_distributed, where there is no host codec;
an input file goes through smooth_jpeg_distributed, and rank 0 writes
the output file as the launcher does.  ``--save out.npz`` writes rank
0's planes (``coef0``.., ``up1`` / ``up2``, ``stop``).  ``--reps N`` runs
N times and reports each run's time (the first also loads the kernels
and warms the allocator).  ``--batch N`` runs smooth_batch_distributed
on N synthetic gray frames a rank (seeds SEED + rank * N + i) and saves
each rank's results as ``BASE.rank<r>.npz``.  Each rank prints its
kernel launches (cuda_solver.LAUNCHES, as JSON), and rank 0 each run's
time and the host time of the last run's point-to-point exchanges.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from jpegqs_tpu_torch.parallel import run_multihost  # noqa: E402


def parse_args(argv):
    p = run_multihost.build_parser()
    p.add_argument("--synth", default=None, metavar="H,W,COLOR,SEED",
                   help="a synthetic image instead of infile")
    p.add_argument("--save", default=None, help="npz of rank 0's planes")
    p.add_argument("--batch", type=int, default=0, metavar="N",
                   help="smooth_batch_distributed on N frames a rank")
    p.add_argument("--reps", type=int, default=1, metavar="N",
                   help="run N times, each run's time reported")
    p.add_argument("infile", nargs="?")
    p.add_argument("outfile", nargs="?")
    return p.parse_args(argv)


def _synth_image(spec, seed_offset=0):
    from jpegqs_tpu_torch import synth
    h, w, color, seed = spec.split(",")
    return synth.make_image(int(h), int(w), color=color.lower() in
                            ("1", "true", "color", "colour"),
                            seed=int(seed) + seed_offset)


def _timed(reps, fn):
    """(fn()'s last result, each run's host ms), sharded.P2P counting the
    last run's exchanges only."""
    from jpegqs_tpu_torch.parallel import sharded
    times = []
    for _ in range(max(reps, 1)):
        sharded.P2P.update(calls=0, seconds=0.0, bytes=0)
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def _run(args, devices, rank) -> int:
    import numpy as np
    import torch.distributed as dist
    from jpegqs_tpu_torch.options import QsOptions
    from jpegqs_tpu_torch.parallel import multihost, sharded
    opts = QsOptions.from_quality(args.quality, args.niter)
    if args.batch:
        imgs = [_synth_image(args.synth, rank * args.batch + i)
                for i in range(args.batch)]
        comp = imgs[0].components[0]
        coefs = np.stack([np.asarray(im.components[0].coefs, np.int16)
                          .reshape(comp.height_in_blocks,
                                   comp.width_in_blocks, 64)
                          for im in imgs])
        out, ms = _timed(args.reps, lambda: multihost.smooth_batch_distributed(
            coefs, comp.quantval, opts.flags, opts.niter, devices=devices))
        np.savez(f"{args.save}.rank{rank}.npz", coefs=out)
        print(f"multihost_worker: rank {rank}: {args.batch} frames in "
              f"{', '.join(f'{t:.3f}' for t in ms)} ms", file=sys.stderr)
        return 0
    data = None
    if args.synth:
        img = _synth_image(args.synth)
        res, ms = _timed(args.reps, lambda: multihost.smooth_image_distributed(
            img, opts, devices))
    else:
        with open(args.infile, "rb") as f:
            data = f.read()
        res, ms = _timed(args.reps, lambda: multihost.smooth_jpeg_distributed(
            data, opts, devices)[0])
    if rank != 0:
        return 0
    p2p = sharded.P2P
    print(f"multihost_worker: {dist.get_world_size()} ranks x "
          f"{len(devices)} shards, backend {dist.get_backend()}: "
          f"{', '.join(f'{t:.3f}' for t in ms)} ms; rank 0's exchanges with "
          f"other ranks in the last run {p2p['calls']} calls, "
          f"{p2p['seconds'] * 1e3:.3f} ms, {p2p['bytes']} B sent",
          file=sys.stderr)
    if args.save:
        arrays = {f"coef{i}": c for i, c in enumerate(res.coefs)}
        if res.upsampled is not None:
            arrays.update(up1=res.upsampled[0], up2=res.upsampled[1])
        np.savez(args.save, stop=np.int32(res.stop), **arrays)
    if args.outfile and data is not None:
        from jpegqs_tpu_torch.engine import _save_result
        with open(args.outfile, "wb") as f:
            f.write(_save_result(data, res))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.local:
        return run_multihost.local_fanout(
            args.local, argv, args.timeout,
            cmd=[sys.executable, os.path.abspath(__file__)])
    import torch.distributed as dist
    from jpegqs_tpu_torch.ops import cuda_solver
    devices = run_multihost.join(args)
    rank = dist.get_rank()
    try:
        return _run(args, devices, rank)
    finally:
        print(f"multihost_worker: rank {rank} launches "
              f"{json.dumps(cuda_solver.LAUNCHES)}", file=sys.stderr)
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
