#!/usr/bin/env python3
"""Time the solver kernels B2 (solve_rebalance_pix) and B3 (solve_fused_pix
with the JOINT_YUV preamble) of a checkout of this repository on one card,
at the main path's largest inputs.

    python3 tools/time_solver_kernels.py [TREE]

TREE is the root of a checkout (default: the one holding this script);
its ``jpegqs_tpu_torch`` is imported and its kernels are built under
TREE/build.  The inputs, the timer and the ptxas lines are this checkout's
``chip_smoke.py`` (``main_path_planes``, ``cuda_ms``, ``ptxas_lines``) and
only the wrappers' public signatures are used, so two commits compare on
one card within one call, in turns:

    for t in old new new old; do python3 tools/time_solver_kernels.py $t; done

B2 runs on the 12 MP 4:2:0 photo's 375x500 luma plane (q3 pass, NT 144;
q4-q6 luma pass, NT 242); B3 on its 188x250 chroma plane (q6: sweep NT
242; q2: no sweep) and on a chroma plane of 4:4:4 size.

Then the same kernels on planes of exactly m CTAs of 128 threads per SM
(m = 1, 2, 3, 4: one wave; 8: two), random coefficients and pixels: how
the time grows with the warps an SM holds tells a latency-bound kernel
(little growth up to the occupancy limit) from an issue-bound one
(growth in proportion).

Prints the ptxas lines of TREE's build, then one JSON line: the card
(nvidia-smi name and power limit), the tree, per configuration the median
of 20 CUDA-event timed launches (ms), and per m the scaling times.  Exits
1 without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

REPS = 20
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_here(name, rel):
    """Module ``rel`` of this checkout, whatever TREE's package is."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_solver_kernels: no CUDA device", file=sys.stderr)
        return 1
    # chip_smoke's package imports resolve to TREE's package
    smoke = load_here("chip_smoke", "chip_smoke.py")
    report = load_here("jq_build_here", "jpegqs_tpu_torch/ops/_build.py")
    from jpegqs_tpu_torch import synth
    from jpegqs_tpu_torch.ops import _build, cuda_solver, dct
    from jpegqs_tpu_torch.ops.quant import make_quant_tables
    assert os.path.dirname(os.path.abspath(_build.__file__)).startswith(tree)
    path = _build.build()
    _build.load()
    card = smoke.nvidia_smi()
    with open(path + ".log") as f:
        for line in smoke.ptxas_lines(report.ptxas_report(f.read()), card):
            print(f"  ptxas: {line}", flush=True)

    img = synth.make_image(*smoke.COLOR_HW, color=True, seed=0)
    (coef, pix, tabs, hb, wb, ccoef, cpix, ctabs, hbc, wbc, image2,
     image2_444) = smoke.main_path_planes(img)
    q = smoke.Q_FLAGS
    B, Bc = hb * wb, hbc * wbc
    b2 = cuda_solver.solve_rebalance_pix
    b3 = cuda_solver.solve_fused_pix
    runs = {
        f"B2 NT 144, {B} blocks":
            lambda: b2(coef, pix, *tabs, q[3], True, hb, wb),
        f"B2 NT 242, {B} blocks":
            lambda: b2(coef, pix, *tabs, q[4], True, hb, wb),
        f"B3 q6, {Bc} blocks":
            lambda: b3(ccoef, cpix, image2, *ctabs, q[6], True, hbc, wbc),
        f"B3 q2, {Bc} blocks":
            lambda: b3(ccoef, cpix, image2, *ctabs, q[2], True, hbc, wbc),
        f"B3 q6, {B} blocks (4:4:4)":
            lambda: b3(coef, pix, image2_444, *tabs, q[6], True, hb, wb),
        f"B3 q2, {B} blocks (4:4:4)":
            lambda: b3(coef, pix, image2_444, *tabs, q[2], True, hb, wb),
    }
    ms = {name: smoke.cuda_ms(fn, REPS) for name, fn in runs.items()}

    rng = np.random.default_rng(0)
    qs = rng.integers(4, 60, 64).astype(np.uint16)
    stabs = [smoke.to_dev(t) for t in make_quant_tables(qs)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scaling = {}
    for m in (1, 2, 3, 4, 8):
        n = m * sms * 128
        sc = np.clip(rng.integers(-20, 21, (64, n)) * qs.astype(np.int32)[
            :, None], -32768, 32767).astype(np.int32)
        scoef = smoke.to_dev(sc)
        spix = dct.idct_islow(scoef.reshape(8, 8, -1)).reshape(64, -1)
        simg2 = smoke.to_dev(rng.integers(0, 256, (100, n)).astype(np.int32))
        sh, sw = n // 128, 128
        scaling[f"{m} CTAs per SM, {n} blocks"] = {
            "B2 NT 144": smoke.cuda_ms(lambda: b2(
                scoef, spix, *stabs, q[3], True, sh, sw), REPS),
            "B2 NT 242": smoke.cuda_ms(lambda: b2(
                scoef, spix, *stabs, q[4], True, sh, sw), REPS),
            "B3 q6": smoke.cuda_ms(lambda: b3(
                scoef, spix, simg2, *stabs, q[6], True, sh, sw), REPS),
            "B3 q2": smoke.cuda_ms(lambda: b3(
                scoef, spix, simg2, *stabs, q[2], True, sh, sw), REPS)}
    print(json.dumps({"card": card, "tree": tree, "reps": REPS, "ms": ms,
                      "scaling_ms": scaling}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
