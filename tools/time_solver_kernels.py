#!/usr/bin/env python3
"""Time the solver kernels B2 (solve_rebalance_pix), B3 / B4
(solve_fused_pix with the JOINT_YUV / LOW_QUALITY preamble), B5
(solve_rebalance, on given border lines), B6 (solve_fused, on given
halos) and B7 (solve_range_pix, a block range of a shard) of a checkout
of this repository on one card, at the inputs of PERF.md's kernel
table.

    python3 tools/time_solver_kernels.py [TREE]

TREE is the root of a checkout (default: the one holding this script);
its ``jpegqs_tpu_torch`` is imported and its kernels are built under
TREE/build.  The inputs, the timer and the ptxas lines are this checkout's
``chip_smoke.py`` (``main_path_planes``, ``shard_ext``, ``cuda_ms``,
``kernel_ms``, ``ptxas_lines``) and only the wrappers' public signatures
are used, so two commits compare on one card within one call, in turns:

    for t in old new new old; do python3 tools/time_solver_kernels.py $t; done

B2 runs on the 12 MP 4:2:0 photo's 375x500 luma plane (q3 pass, NT 144;
q4-q6 luma pass, NT 242); B3 on its 188x250 chroma plane (q6: sweep NT
242; q2: no sweep) and on a chroma plane of 4:4:4 size; B4 (q0 pass) on
the luma plane and on the 135x240 plane of the 2.1 MP gray frame; B5 and
B6 as the progress path calls them, on border lines / halos materialised
from the whole plane (B5 at NT 144 and 242 on the luma plane and on its
PRECISE_PROGRESS row chunks of 85 and 11 block rows -- 42,500 and 5,500
blocks, column-slice views of the plane, as engine.block_pass(rows=...)
passes them; B6 JOINT q6 and q2 on the chroma plane, LQ q0 on the luma
plane); B7 on
the last of 4 shards of those planes (46,500 luma blocks: its B2 form at
NT 144 and 242 and its LQ form; 11,750 chroma blocks: JOINT at q6, at
NT 144 and at q2), as chip_smoke.phase_b7_full_shard.

Then the same kernels on planes of exactly m CTAs of 128 one-block
threads per SM (m = 1/4 and 1/2: under one wave; 1, 2, 3, 4: one wave for
the one-thread kernels; 8: two), random coefficients and pixels: how the
time grows with the warps an SM holds tells a latency-bound kernel
(little growth up to the occupancy limit) from an issue-bound one (growth
in proportion).  The planes are the same work for every tree; a kernel
with several lanes per block (the LOW_QUALITY ones: 8) runs them as that
many times the CTAs.  B5 and B7-joint run with their profiler
kernel-only times too (below one wave a launch's event time is mostly the
host's): B5 on random border lines, by the tree's own choice of body
(the lane body on few CTAs an SM); B7-joint over the whole plane as one
range (both edges flagged), up to two CTAs an SM the one-thread joint
body, above them B3's design.  Where the tree's B5 wrapper takes a
``lanes`` argument, each of B5's two bodies also runs on planes of m =
1/4 .. 2 CTAs an SM (kernel-only): where their times cross is the size
at which B5 changes body.

Last, the row flow's device window through TREE's make_sharded_* functions
(``sharded_ms``): the 4032x3024 frame at q6 n3 on 2 and 4 shards of this
card and the gray frame at q0 n3 on 4, as chip_smoke.phase_sharded runs
them.

Prints the ptxas lines of TREE's build, then one JSON line: the card
(nvidia-smi name and power limit), the tree, per configuration the median
of 20 CUDA-event timed launches (ms) and the profiler's kernel-only time
per launch over 20 (kernel_ms), per m the scaling times and, where
measured, B5's bodies (b5_bodies_ms), and the sharded runs' medians of 5
(sharded_ms).  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import inspect
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


def b7_edges(cuda_solver, edges, wb):
    """A row shard's edges as TREE's B7 takes them: (top_row, bot_row,
    left_col, right_col) with the grid's columns, or (top_row, bot_row)
    in a checkout from before B7 took column edges."""
    four = (*edges, 0, wb - 1)
    try:
        cuda_solver.check_range(wb, wb, 0, 0, four)
    except ValueError:
        return tuple(edges)
    return four


def sharded_ms(smoke, torch, np, engine, sharded, synth):
    """The row flow's device window (CUDA events, median of 5, inputs on
    the card) through TREE's make_sharded_* functions, over shards of this
    card: the 4032x3024 4:2:0 frame at q6 n3 on 2 and 4 shards, the 2.1 MP
    gray frame at q0 n3 on 4 (chip_smoke.phase_sharded's runs)."""
    from jpegqs_tpu_torch import QsOptions
    from jpegqs_tpu_torch.ops.quant import make_quant_tables
    aligned = synth.make_image(*smoke.ALIGNED_HW, color=True, seed=0)
    gray = synth.make_image(*smoke.GRAY_HW, color=False, seed=0)

    def inputs(c):
        qraw = np.asarray(c.quantval, np.int32)
        return (smoke.to_dev(np.asarray(c.coefs, np.int16).reshape(
            c.height_in_blocks, c.width_in_blocks, 64)),
            [smoke.to_dev(t) for t in (qraw, *make_quant_tables(qraw))])

    out = {}
    y, cb = aligned.components[:2]
    ins = [inputs(c) for c in aligned.components]
    for n in (2, 4):
        fn = sharded.make_sharded_ycbcr_smooth(
            ["cuda"] * n, hb_l=y.height_in_blocks, wb_l=y.width_in_blocks,
            hb_c=cb.height_in_blocks, wb_c=cb.width_in_blocks, ws=2, hs=2,
            flags=QsOptions.from_quality(6, 3).flags, niter=3,
            img_w=aligned.width, img_h=aligned.height)
        out[f"4032x3024 q6 n3, {n} shards"] = smoke.cuda_ms(
            lambda: fn(*(p for p, _ in ins), *(t for _, t in ins)), 5)
    c = gray.components[0]
    p, t = inputs(c)
    fn = sharded.make_sharded_smooth(
        ["cuda"] * 4, hb=c.height_in_blocks, wb=c.width_in_blocks,
        flags=QsOptions.from_quality(0, 3).flags, niter=3)
    out["1920x1080 gray q0 n3, 4 shards"] = smoke.cuda_ms(lambda: fn(p, *t),
                                                          5)
    return out


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
    from jpegqs_tpu_torch import JOINT_YUV, engine, synth
    from jpegqs_tpu_torch.ops import _build, cuda_solver, dct
    from jpegqs_tpu_torch.parallel import sharded
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
    gray = synth.make_image(*smoke.GRAY_HW, color=False, seed=0)
    gcoef, gpix, gtabs, hbg, wbg = smoke._plane_inputs(gray, 0)
    q = smoke.Q_FLAGS
    B, Bc, Bg = hb * wb, hbc * wbc, hbg * wbg
    b2 = cuda_solver.solve_rebalance_pix
    b3 = cuda_solver.solve_fused_pix      # B4 when image2 is None
    b6 = cuda_solver.solve_fused
    b7 = cuda_solver.solve_range_pix
    b5 = cuda_solver.solve_rebalance
    halo = engine.neighbourhood(pix, None, q[0], hb, wb)
    borders = engine.neighbourhood(pix, None, q[4], hb, wb)
    chalo = engine.neighbourhood(cpix, image2, q[6], hbc, wbc)
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
        f"B4 q0, {B} blocks":
            lambda: b3(coef, pix, None, *tabs, q[0], True, hb, wb),
        f"B4 q0, {Bg} blocks (gray)":
            lambda: b3(gcoef, gpix, None, *gtabs, q[0], True, hbg, wbg),
        f"B5 NT 144, {B} blocks":
            lambda: b5(coef, borders, *tabs, q[3], True),
        f"B5 NT 242, {B} blocks":
            lambda: b5(coef, borders, *tabs, q[4], True),
        f"B6 joint q6, {Bc} blocks":
            lambda: b6(ccoef, chalo, image2, *ctabs, q[6], True),
        f"B6 joint q2, {Bc} blocks":
            lambda: b6(ccoef, chalo, image2, *ctabs, q[2], True),
        f"B6 lq q0, {B} blocks":
            lambda: b6(coef, halo, None, *tabs, q[0], True),
    }
    # B5 on row chunks of the luma plane (column-slice views), as the
    # progress run's PRECISE_PROGRESS chunks: 85 and 11 block rows
    for r0, rows in ((100, 85), (300, 11)):
        s = slice(r0 * wb, (r0 + rows) * wb)
        for nt, flags in ((144, q[3]), (242, q[4])):
            runs[f"B5 NT {nt}, {rows * wb}-block chunk"] = (
                lambda s=s, flags=flags: b5(coef[:, s], borders[:, s], *tabs,
                                            flags, True))
    # B7 on the last of 4 shards, whole range, pixels emitted
    n, r = 4, 3
    for plane, xs, t, w, h, sets in (
            ("luma", (coef, pix, None), tabs, wb, hb,
             (("B2 form NT 144", q[3]), ("B2 form NT 242", q[4]),
              ("lq q0", q[0]))),
            ("chroma", (ccoef, cpix, image2), ctabs, wbc, hbc,
             (("joint q6", q[6]), ("joint JOINT NT 144", JOINT_YUV),
              ("joint q2", q[2])))):
        ext = [None if x is None else smoke.shard_ext(x, r, n, w)
               for x in xs]
        real, edges = smoke.shard_rows(r, h, sharded._pad_to(h, n) // n)
        edges = b7_edges(cuda_solver, edges, w)
        outs = [torch.empty_like(ext[0]) for _ in range(2)]
        for what, flags in sets:
            args = (*ext, *t, flags, True, w, w, (real + 1) * w, edges, *outs)
            runs[f"B7 {what}, {real * w} {plane} blocks"] = (
                lambda args=args: b7(*args))
    ms = {name: smoke.cuda_ms(fn, REPS) for name, fn in runs.items()}
    kernel_ms = {name: smoke.kernel_ms(fn, REPS) for name, fn in runs.items()}

    rng = np.random.default_rng(0)
    qs = rng.integers(4, 60, 64).astype(np.uint16)
    stabs = [smoke.to_dev(t) for t in make_quant_tables(qs)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scaling = {}
    for m in (0.25, 0.5, 1, 2, 3, 4, 8):
        n = int(m * sms) * 128
        sc = np.clip(rng.integers(-20, 21, (64, n)) * qs.astype(np.int32)[
            :, None], -32768, 32767).astype(np.int32)
        scoef = smoke.to_dev(sc)
        spix = dct.idct_islow(scoef.reshape(8, 8, -1)).reshape(64, -1)
        simg2 = smoke.to_dev(rng.integers(0, 256, (100, n)).astype(np.int32))
        sbord = smoke.to_dev(rng.integers(0, 256, (32, n)).astype(np.int32))
        sh, sw = n // 128, 128
        souts = [torch.empty_like(scoef) for _ in range(2)]

        def b7_joint(flags):
            return lambda: b7(scoef, spix, simg2, *stabs, flags, True, sw, 0,
                              n, b7_edges(cuda_solver, (0, sh - 1), sw),
                              *souts)
        row = {
            "B2 NT 144": smoke.cuda_ms(lambda: b2(
                scoef, spix, *stabs, q[3], True, sh, sw), REPS),
            "B2 NT 242": smoke.cuda_ms(lambda: b2(
                scoef, spix, *stabs, q[4], True, sh, sw), REPS),
            "B3 q6": smoke.cuda_ms(lambda: b3(
                scoef, spix, simg2, *stabs, q[6], True, sh, sw), REPS),
            "B3 q2": smoke.cuda_ms(lambda: b3(
                scoef, spix, simg2, *stabs, q[2], True, sh, sw), REPS),
            "B4 q0": smoke.cuda_ms(lambda: b3(
                scoef, spix, None, *stabs, q[0], True, sh, sw), REPS)}
        for nt, f in ((144, 3), (242, 4)):
            def b5_plane(flags=q[f]):
                return b5(scoef, sbord, *stabs, flags, True)
            row[f"B5 NT {nt}"] = smoke.cuda_ms(b5_plane, REPS)
            row[f"B5 NT {nt} kernel_ms"] = smoke.kernel_ms(b5_plane, REPS)
        for f in (6, 2):
            row[f"B7 joint q{f}"] = smoke.cuda_ms(b7_joint(q[f]), REPS)
            row[f"B7 joint q{f} kernel_ms"] = smoke.kernel_ms(b7_joint(q[f]),
                                                              REPS)
        scaling[f"{m} CTAs per SM, {n} blocks"] = row
    bodies = {}
    if "lanes" in inspect.signature(b5).parameters:
        for m in (0.25, 0.5, 1, 1.25, 1.5, 2):
            n = int(m * sms) * 128
            sc = smoke.to_dev(np.clip(rng.integers(-20, 21, (64, n))
                                      * qs.astype(np.int32)[:, None], -32768,
                                      32767).astype(np.int32))
            sb = smoke.to_dev(rng.integers(0, 256, (32, n)).astype(np.int32))
            bodies[f"{m} CTAs per SM, {n} blocks"] = {
                f"B5 NT {nt} {'lanes' if lanes else 'B2 body'}":
                    smoke.kernel_ms(lambda f=q[f], lanes=lanes: b5(
                        sc, sb, *stabs, f, True, lanes=lanes), REPS)
                for nt, f in ((144, 3), (242, 4)) for lanes in (True, False)}
    print(json.dumps({"card": card, "tree": tree, "reps": REPS, "ms": ms,
                      "kernel_ms": kernel_ms, "scaling_ms": scaling,
                      "b5_bodies_ms": bodies,
                      "sharded_ms": sharded_ms(smoke, torch, np, engine,
                                               sharded, synth)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
