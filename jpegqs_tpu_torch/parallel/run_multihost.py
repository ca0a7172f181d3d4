"""Multi-process launcher: the port of ``tools/run_multihost.py``.

One rank of a job (run the same command on every host, each with its
rank and its place among its host's ranks; rank 0 listens at the
address)::

    python -m jpegqs_tpu_torch.parallel.run_multihost \\
        --init-method tcp://host0:29500 --world-size 8 --rank $RANK \\
        --local-rank $LOCAL_RANK --local-world-size 4 \\
        [--shards-per-rank 2] [--device cpu] [--backend gloo] \\
        -q 3 -n 3 in.jpg out.jpg

Local fan-out (every rank on this machine, each with its own timeout;
a rank that fails or times out stops the others)::

    python -m jpegqs_tpu_torch.parallel.run_multihost --local 2 \\
        --shards-per-rank 2 --device cpu in.jpg out.jpg

Every rank decodes the input; the image is sharded over every device of
the job (parallel/multihost.py) and rank 0 re-encodes and writes the
output.  Each rank prints the backend it joined with.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(prog="run_multihost")
    p.add_argument("--init-method", default=None,
                   help="tcp://host:port of rank 0")
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--local-rank", type=int, default=None,
                   help="this rank's place among its host's ranks "
                        "(default --rank on a loopback address)")
    p.add_argument("--local-world-size", type=int, default=None,
                   help="the ranks on this host (default --world-size on "
                        "a loopback address)")
    p.add_argument("--local", type=int, default=0, metavar="N",
                   help="spawn N ranks on this machine")
    p.add_argument("--shards-per-rank", type=int, default=1,
                   help="shards of the rank's device each rank runs")
    p.add_argument("--device", default=None,
                   help="cpu, or a card (default: the card)")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds each local rank may take")
    p.add_argument("-q", "--quality", type=int, default=3)
    p.add_argument("-n", "--niter", type=int, default=3)
    return p


def parse_args(argv=None):
    p = build_parser()
    p.add_argument("infile")
    p.add_argument("outfile")
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_fanout(n, argv, timeout, cmd=None) -> int:
    """Start ``n`` ranks of ``cmd`` (default this launcher) on this
    machine with ``argv`` less its ``--local N``, and wait for them, each
    within ``timeout`` seconds; when one fails or times out, the others
    are stopped.  Returns 0 when every rank exited 0, else the first
    failing rank's code (124 for a timeout)."""
    if cmd is None:
        cmd = [sys.executable, "-m", "jpegqs_tpu_torch.parallel.run_multihost"]
    init = f"tcp://127.0.0.1:{free_port()}"
    rest = []
    skip = False
    for a in argv:          # drop --local N / --local=N
        if skip:
            skip = False
            continue
        if a == "--local":
            skip = True
            continue
        if a.startswith("--local="):
            continue
        rest.append(a)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [*cmd, "--init-method", init, "--world-size", str(n),
         "--rank", str(r), "--local-rank", str(r), "--local-world-size",
         str(n), *rest], env=env) for r in range(n)]
    deadline = time.monotonic() + timeout
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                rc = failed[0] if failed else 124
                if not failed:
                    print(f"run_multihost: a rank ran past {timeout} s",
                          file=sys.stderr)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if rc == 0:
        rc = next((p.returncode for p in procs if p.returncode), 0)
    return rc


def join(args):
    """Join the job the arguments name; returns this rank's devices
    (``--shards-per-rank`` shards of its device)."""
    from jpegqs_tpu_torch.parallel import multihost

    multihost.initialize(args.init_method, args.world_size, args.rank,
                         backend=args.backend, device=args.device,
                         local_rank=args.local_rank,
                         local_world_size=args.local_world_size)
    return [multihost.joined_device()] * args.shards_per_rank


def worker(args) -> int:
    import torch.distributed as dist
    from jpegqs_tpu_torch.engine import _save_result
    from jpegqs_tpu_torch.options import QsOptions
    from jpegqs_tpu_torch.parallel import multihost

    devices = join(args)
    try:
        with open(args.infile, "rb") as f:
            data = f.read()
        res, _ = multihost.smooth_jpeg_distributed(
            data, QsOptions.from_quality(args.quality, args.niter), devices)
        if dist.get_rank() == 0:
            with open(args.outfile, "wb") as f:
                f.write(_save_result(data, res))
            print(f"run_multihost: wrote {args.outfile} "
                  f"({dist.get_world_size()} ranks x {len(devices)} shards, "
                  f"backend {dist.get_backend()}, stop {res.stop})",
                  file=sys.stderr)
        return 0
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.local:
        return local_fanout(args.local, argv, args.timeout)
    if args.init_method is None or args.world_size is None \
            or args.rank is None:
        print("run_multihost: give --init-method, --world-size and --rank, "
              "or --local N", file=sys.stderr)
        return 2
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
