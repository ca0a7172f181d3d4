"""The control of the `correct` check: the plain reference put in the
program's place and computed in bfloat16, the nearest precision below
the float32 that the configuration's guarantee (bit-exactness with the
command-line tool) rests on.  It has to come out as not correct.

    python benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's pool of images, takes the batches that
a run would keep for its check (the first ``check_batches`` of the
seed's batch order, at the cell's own sizes), computes them with the
bfloat16 reference in the program's place and judges them against the
float32 reference with the run's own comparison.  It prints one JSON
line per seed with each number compared and whether it passed its limit;
the benchmark's own runs never run it.  The output does not depend on
load, so no measured window is needed.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_checks(bench, wl, seed, device, overrides=None):
    """(checks, correct) of the bfloat16 reference in the program's place
    on ``seed``'s kept batches of cell ``wl``."""
    import torch

    from benchmark.harness import cell, check, drive, photos, spec

    cfg = spec.config(bench, wl["config"])
    traffic = dict(spec.traffic(wl["traffic"]), **(overrides or {}))
    dev = torch.device(device)
    pool = photos.make_pool(traffic, seed, dev)
    order = drive.batch_order(traffic, seed)
    batches = [drive.Batch(k, next(order), 0.0, 0.0)
               for k in range(traffic.get("check_batches", 1))]
    needed = {i for b in batches for i in b.images}
    low = cell.reference_results(pool, needed, cfg, dev, torch.bfloat16)
    ref = cell.reference_results(pool, needed, cfg, dev)
    kept = [(b, [low[i] for i in b.images]) for b in batches]
    checks, _ = check.checks(kept, ref,
                             sum(len(b.images) for b in batches), 0)
    return checks, all(check.passed(c) for c in checks.values())


def main(argv):
    import argparse
    import json

    import torch

    from benchmark.harness import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    wl = spec.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        checks, correct = control_checks(bench, wl, seed, "cuda")
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "control_correct": correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
