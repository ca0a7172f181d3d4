#!/usr/bin/env python
"""Randomized differential fuzz of the PyTorch/CUDA port, jpegqs_tpu_torch.

The port's counterpart of tools/fuzz_differential.py.  The structured
tests pin the known-interesting configurations; this tool samples the
input space -- random dimensions, content, colour space, sampling
factors, source quality, quality level, niter, raw flag sets and damaged
inputs -- runs every path of the port on each case and holds it bit for
bit against an oracle: the int16 planes, the upsampled planes, ``stop``,
the progress callback's ``(cur, max)`` trace and the decoded pixels.

Two modes, chosen by ``--device``:

``--device cpu`` (the oracle mode)
    The port's plain PyTorch versions on the CPU against ``jpegqs_tpu``
    on JAX_PLATFORMS=cpu (imported on first use).  Cases alternate
    between two sources: ``synth`` (numpy alone:
    jpegqs_tpu_torch.synth, with damaged tables and coefficients and
    3- and 4-component images that are not YCbCr) and ``jpeg``
    (fuzz_differential.sample_case's space -- gray, colour and CMYK at
    every subsampling, progressive, arithmetic and restart coding --
    encoded and read back by the port's libjpeg codec).
``--device cuda`` (the default, as for every entry point of the port)
    The CUDA kernels, held against the port's own CPU run of the same
    case on the same machine (the plain versions, which the CPU mode
    ties to jpegqs_tpu); the card's grid, batch and progress runs also
    against its single-device run.  ``synth`` cases only, as the card's
    machine may have neither JAX nor libjpeg.  It first replays
    tools/fuzz_port_golden.json, the SHA-256 digests of jpegqs_tpu's
    output for fixed cases: a direct link from the card to JAX.  Without
    a card it exits non-zero; it never runs on the CPU instead.

Paths run on every case (the oracle's counterpart in brackets):

- fused: ``engine.smooth(img, opts, device)`` [``engine.smooth``];
- progress: the same with a recording callback, ``precise`` and
  ``progprec`` (0, > 0, < 0) drawn; every 5th case cancels at a drawn
  callback [the same callback settings; in card mode also the fused run
  when nothing was cancelled, except where jpegqs_tpu's two paths differ,
  ``fused_differs_from_progress``];
- grid: ``engine._smooth_on_shards`` on a drawn r x c grid (1-3 x 1-3)
  of shards of the one device, where the engine would shard the image
  on that grid (``engine._shard_grid`` with JPEGQS_SHARD_MIN_BLOCKS=1,
  enough block rows and columns, ``choose_grid``'s narrow-UPSAMPLE_UV
  rule); a refused grid is reported as skipped [``engine.smooth``];
- batch, every 4th case: 2-3 images of the case's geometry with other
  seeds through ``batch.smooth_image_batch``, gray ones also through
  ``smooth_plane_batch`` [the batch functions, and ``engine.smooth`` of
  each image];
- decode, every 3rd case: ``engine._decode_native`` of the result
  [the same of the oracle's result];
- transcode, every 12th case from the ``jpeg`` source:
  ``smooth_jpeg_bytes`` and ``smooth_many`` of four files [the same],
  compared on the coefficients of the output bytes.

Each case comes from its own generator, seeded by (seed, case index), and
is printed as JSON, so a mismatch is a one-line repro.

Usage:
    python tools/fuzz_port.py --device cpu --cases 40 --seed 1
    python tools/fuzz_port.py --seconds 60          # on the card
    python tools/fuzz_port.py --device D --seed S --case I   # one case
    python tools/fuzz_port.py --device cpu --write-golden \\
        tools/fuzz_port_golden.json
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np
import torch

from chip_smoke import digest, pixel_digest
from jpegqs_tpu_torch import (ITER_MAX, UPSAMPLE_UV, QsOptions, batch,
                              engine, synth)
from jpegqs_tpu_torch.host import jpegio
from jpegqs_tpu_torch.parallel import sharded

GOLDEN_PATH = os.path.join(REPO, "tools", "fuzz_port_golden.json")
GOLDEN_SEED = 20261020
GOLDEN_CASES = 48
GOLDEN_MAX_HW = 48          # these two keep the replay on the CPU to
GOLDEN_MAX_NITER = 2        # seconds
CLEAR_EVERY = 20

SAMPLINGS = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2))
GRIDS = tuple((r, c) for r in (1, 2, 3) for c in (1, 2, 3) if r * c > 1)
PATHS = ("fused", "progress", "grid", "batch", "decode")


class Mismatch(AssertionError):
    """A path's output differs from its oracle's."""

    def __init__(self, path, what, detail):
        super().__init__(f"path {path}, {what}: {detail}")
        self.path, self.what, self.detail = path, what, detail


def first_mismatch(a: np.ndarray, b: np.ndarray):
    """Locate and describe the first mismatching element (the copy of
    tests/util.first_mismatch)."""
    if np.array_equal(a, b):
        return None
    idx = np.argwhere(a != b)
    i = tuple(int(x) for x in idx[0])
    return {"index": i, "got": a[i], "want": b[i], "count": len(idx)}


def check_array(path, what, got, want):
    if got is None or want is None:
        if got is not want:
            raise Mismatch(path, what, f"got {type(got).__name__}, want "
                           f"{type(want).__name__}")
        return
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise Mismatch(path, what, f"got {got.dtype}{list(got.shape)}, "
                       f"want {want.dtype}{list(want.shape)}")
    bad = first_mismatch(got, want)
    if bad is not None:
        raise Mismatch(path, what, bad)


def check_result(path, got, want):
    """Two SmoothResults: stop, every plane, the upsampled planes."""
    if int(got.stop) != int(want.stop):
        raise Mismatch(path, "stop", f"got {got.stop}, want {want.stop}")
    if len(got.coefs) != len(want.coefs):
        raise Mismatch(path, "components",
                       f"got {len(got.coefs)}, want {len(want.coefs)}")
    for ci, (a, b) in enumerate(zip(got.coefs, want.coefs)):
        check_array(path, f"component {ci}", a, b)
    if (got.upsampled is None) != (want.upsampled is None):
        raise Mismatch(path, "upsampled planes",
                       f"got {got.upsampled is not None}, want "
                       f"{want.upsampled is not None}")
    for name, a, b in zip(("upsampled Cb", "upsampled Cr"),
                          got.upsampled or (), want.upsampled or ()):
        check_array(path, name, a, b)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def sample_case(seed, i, source="synth", max_hw=229):
    """Case ``i`` of ``seed`` from ``source`` ("synth" or "jpeg"), with the
    paths it runs; every field JSON-printable."""
    rng = np.random.default_rng([seed, i])
    case = {"source": source,
            "h": int(rng.integers(8, max_hw + 1)),
            "w": int(rng.integers(8, max_hw + 1)),
            "kind": str(rng.choice(synth.KINDS)),
            "seed": int(rng.integers(0, 1 << 31))}
    if source == "jpeg":
        # tools/fuzz_differential.sample_case's space
        case.update({
            "color": str(rng.choice(["gray", "color", "cmyk"],
                                    p=[0.3, 0.55, 0.15])),
            "progressive": bool(rng.random() < 0.15),
            "arith": bool(rng.random() < 0.10),
            "restart": int(rng.choice([0, 0, 0, 1, 3, 7]))})
        case["subsamp"] = (int(rng.integers(0, 6))
                           if case["color"] == "color" else 1)
    else:
        case["color"] = str(rng.choice(["gray", "ycc", "rgb", "cmyk"],
                                       p=[0.3, 0.5, 0.1, 0.1]))
        case["sampling"] = (list(SAMPLINGS[rng.integers(len(SAMPLINGS))])
                            if case["color"] == "ycc" else [1, 1])
        case["damage"] = [None, *synth.DAMAGES][
            int(rng.choice(4, p=[0.55, 0.15, 0.15, 0.15]))]
        ncomp = {"gray": 1, "ycc": 3, "rgb": 3, "cmyk": 4}[case["color"]]
        case["damage_comp"] = int(rng.integers(ncomp))
    case["srcq"] = int(rng.integers(12, 97))
    case["quality"] = int(rng.integers(0, 7))
    case["niter"] = int(rng.choice([0, 1, 2, 3, 4, 5, 8]))
    case["flags"] = None
    if rng.random() < 0.25:
        # raw flag set: algorithm bits 0-5 (DIAGONALS, JOINT_YUV,
        # UPSAMPLE_UV, LOW_QUALITY, NO_REBALANCE, NO_REBALANCE_UV)
        case["flags"] = int(rng.integers(0, 64))
        case["niter"] = int(rng.choice([0, 1, 2, 3]))
    prec = int(rng.integers(0, 3))
    case["progress"] = {
        "precise": bool(rng.random() < 0.5),
        "progprec": (0, -1, int(rng.integers(1, 60)))[prec],
        "cancel_at": int(rng.integers(1, 6)) if i % 5 == 4 else 0}
    case["grid"] = list(GRIDS[rng.integers(len(GRIDS))])
    case["batch"] = int(rng.integers(2, 4)) if i % 4 == 3 else 0
    case["decode"] = i % 3 == 2
    case["transcode"] = source == "jpeg" and i % 12 == 11
    return case


def case_opts(case) -> QsOptions:
    if case["flags"] is None:
        return QsOptions.from_quality(case["quality"], case["niter"])
    return QsOptions(flags=case["flags"], niter=case["niter"])


def jpeg_data(case, seed=None, w=None) -> bytes:
    """The case's JPEG file (the port's libjpeg codec), of another seed or
    width when asked."""
    color = {"gray": False, "color": True, "cmyk": "cmyk"}[case["color"]]
    pix = synth.synth_image(case["h"], w or case["w"],
                            case["seed"] if seed is None else seed, color,
                            case["kind"])
    return jpegio.encode_pixels(pix, quality=case["srcq"],
                                subsamp=case["subsamp"],
                                progressive=case["progressive"],
                                arith=case["arith"],
                                restart_interval=case["restart"])


def build_image(case, seed=None, damaged=True):
    """The case's JpegImage (of another seed when asked; damaged as the
    case says unless ``damaged`` is false)."""
    if case["source"] == "jpeg":
        return jpegio.read_coefficients(jpeg_data(case, seed))
    seed = case["seed"] if seed is None else seed
    h, w, q, kind = case["h"], case["w"], case["srcq"], case["kind"]
    if case["color"] in ("rgb", "cmyk"):
        img = synth.make_planes_image(h, w, 3 if case["color"] == "rgb"
                                      else 4, seed, q, kind)
    else:
        img = synth.make_image(h, w, color=case["color"] == "ycc", seed=seed,
                               quality=q, sampling=tuple(case["sampling"]),
                               kind=kind)
    if damaged and case["damage"]:
        synth.damage(img, case["damage"], case["damage_comp"], seed)
    return img


def recorder(cancel_at=0):
    """A progress callback recording (cur, max); it cancels (returns 1)
    at its ``cancel_at``-th call, never when 0."""
    calls = []

    def cb(userdata, cur, mx):
        calls.append((int(cur), int(mx)))
        return int(len(calls) == cancel_at)
    return calls, cb


def grid_refusal(img, opts, r, c):
    """Why the engine would not shard ``img`` on an r x c grid, or None:
    ``engine._shard_grid``'s rules with JPEGQS_SHARD_MIN_BLOCKS=1 (an
    iteration, clean quant tables, sampling factors up to 2), at least
    one block row and column a shard, and ``choose_grid``'s rule that a
    colour flow with UPSAMPLE_UV keeps two luma block columns a
    shard."""
    old = os.environ.get("JPEGQS_SHARD_MIN_BLOCKS")
    os.environ["JPEGQS_SHARD_MIN_BLOCKS"] = "1"
    try:
        if engine._shard_grid(img, opts, r * c) is None:
            return "the engine shards no grid of this image"
    finally:
        if old is None:
            del os.environ["JPEGQS_SHARD_MIN_BLOCKS"]
        else:
            os.environ["JPEGQS_SHARD_MIN_BLOCKS"] = old
    comps = img.components
    if r > min(x.height_in_blocks for x in comps):
        return "fewer block rows than shard rows"
    if c > min(x.width_in_blocks for x in comps):
        return "fewer block columns than shard columns"
    if c > 1 and engine._need_downsample(img, opts.flags) \
            and opts.flags & UPSAMPLE_UV \
            and comps[0].width_in_blocks // c < 2:
        return "UPSAMPLE_UV luma under two block columns a shard"
    return None


def fused_differs_from_progress(img, opts) -> bool:
    """Whether jpegqs_tpu's fused path, and so the port's, gives other
    planes than its progress path (ROADMAP.md section C, C2): no
    iteration, UPSAMPLE_UV with a luma sampled above 1x1, and a luma that
    trips the dequantization guard.  The fused path plans the chroma
    components for the upsample before the guard runs, and so dequantizes
    them; the progress path, as the reference (jpegqs_tpu.specref), leaves
    them as they were."""
    if min(max(opts.niter, 0), ITER_MAX):
        return False
    plan = engine.plan_image(img, opts)
    if plan is None or not plan.image1_live:
        return False
    c = img.components[0]
    prod = c.coefs.astype(np.int32) * c.quantval.astype(np.int32)
    return bool((((prod + 0x800) >> 12) != 0).any())


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

class PortCpuOracle:
    """The port's own run on the CPU: the plain versions (card mode)."""

    name = "the port on the CPU"
    single_device_checks = True     # the card is also held against itself

    def smooth(self, img, opts):
        return engine.smooth(img, opts, "cpu")

    def image_batch(self, imgs, opts):
        return batch.smooth_image_batch(imgs, opts, device="cpu")

    def plane_batch(self, coefs, qtbl, flags, niter):
        return batch.smooth_plane_batch(coefs, qtbl, flags, niter, True,
                                        device="cpu")

    def decode(self, img, res):
        return engine._decode_native(img, res, "cpu")

    def smooth_jpeg_bytes(self, data, opts):
        return engine.smooth_jpeg_bytes(data, opts, device="cpu")

    def smooth_many(self, datas, opts):
        return batch.smooth_many(datas, opts, device="cpu")

    def clear(self):
        pass


def import_jax():
    """JAX, on its CPU backend unless the process set it up already."""
    fresh = "jax" not in sys.modules
    if fresh:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    if fresh:
        jax.config.update("jax_platforms", "cpu")
    return jax


class JaxOracle:
    """jpegqs_tpu on JAX's CPU backend, imported on first use (CPU
    mode)."""

    name = "jpegqs_tpu"
    single_device_checks = False

    def __init__(self):
        jax = import_jax()
        import jpegqs_tpu
        from jpegqs_tpu import batch as jbatch, engine as jengine
        from jpegqs_tpu.host import jpegio as jjpegio
        from jpegqs_tpu.options import QsOptions as JaxOptions
        self.jax, self.pkg = jax, jpegqs_tpu
        self.engine, self.batch, self.jpegio = jengine, jbatch, jjpegio
        self.Options = JaxOptions

    def image(self, img):
        """The same decoded image as jpegqs_tpu's JpegImage (the copy of
        tests/test_torch_isolation._to_jax_image)."""
        out = self.jpegio.JpegImage(
            width=img.width, height=img.height,
            jpeg_color_space=img.jpeg_color_space,
            progressive=img.progressive,
            max_h_samp_factor=img.max_h_samp_factor,
            max_v_samp_factor=img.max_v_samp_factor)
        for c in img.components:
            out.components.append(self.jpegio.ComponentData(
                component_id=c.component_id, h_samp_factor=c.h_samp_factor,
                v_samp_factor=c.v_samp_factor, quant_tbl_no=c.quant_tbl_no,
                width_in_blocks=c.width_in_blocks,
                height_in_blocks=c.height_in_blocks,
                quantval=c.quantval.copy(), coefs=c.coefs.copy()))
        return out

    def opts(self, o):
        return self.Options(flags=o.flags, niter=o.niter,
                            progprec=o.progprec, progress=o.progress,
                            precise=o.precise)

    def smooth(self, img, opts):
        return self.engine.smooth(self.image(img), self.opts(opts))

    def image_batch(self, imgs, opts):
        return self.batch.smooth_image_batch([self.image(im) for im in imgs],
                                             self.opts(opts))

    def plane_batch(self, coefs, qtbl, flags, niter):
        return self.batch.smooth_plane_batch(coefs, qtbl, flags, niter, True)

    def decode(self, img, res):
        return self.engine._decode_native(self.image(img), res)

    def smooth_jpeg_bytes(self, data, opts):
        return self.pkg.smooth_jpeg_bytes(data, self.opts(opts))

    def smooth_many(self, datas, opts):
        return self.pkg.smooth_many(datas, self.opts(opts), workers=4)

    def clear(self):
        # every case compiles fresh programs; hundreds of live
        # executables exhaust vm.max_map_count (65530 default) and
        # XLA:CPU starts failing mmaps ("LLVM compilation error:
        # Cannot allocate memory" -- or segfaults mid-deserialize).
        # Dropping the in-process caches unmaps them; the persistent
        # cache makes reloads cheap.
        self.jax.clear_caches()
        gc.collect()


# ---------------------------------------------------------------------------
# One case
# ---------------------------------------------------------------------------

def _coef_files(path, got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        ia, ib = jpegio.read_coefficients(a), jpegio.read_coefficients(b)
        if len(ia.components) != len(ib.components):
            raise Mismatch(path, f"file {k}", "component counts differ")
        for ci, (ca, cb) in enumerate(zip(ia.components, ib.components)):
            check_array(path, f"file {k} component {ci}", ca.coefs, cb.coefs)
            check_array(path, f"file {k} table {ci}", ca.quantval,
                        cb.quantval)


def run_case(case, device, oracle):
    """Every path of ``case`` on ``device`` against ``oracle``; raises
    Mismatch at the first difference.  Returns {path: count} of what ran
    and, under "skipped", why a grid did not."""
    ran = {"skipped": None}
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    img = build_image(case)
    opts = case_opts(case)
    cross = oracle.single_device_checks

    want = oracle.smooth(img, opts)
    res = engine.smooth(img, opts, dev)
    check_result("fused", res, want)
    ran["fused"] = 1

    p = case["progress"]

    def with_progress(cb):
        return QsOptions(flags=opts.flags, niter=opts.niter,
                         progprec=p["progprec"], progress=cb,
                         precise=p["precise"])

    calls, cb = recorder(p["cancel_at"])
    want_calls, want_cb = recorder(p["cancel_at"])
    got = engine.smooth(img, with_progress(cb), dev)
    want_p = oracle.smooth(img, with_progress(want_cb))
    if calls != want_calls:
        k = next((j for j, (a, b) in enumerate(zip(calls, want_calls))
                  if a != b), min(len(calls), len(want_calls)))
        raise Mismatch("progress", "callback trace",
                       f"{len(calls)} calls, want {len(want_calls)}; "
                       f"first difference at call {k}: "
                       f"{calls[k:k + 1]} vs {want_calls[k:k + 1]}")
    check_result("progress", got, want_p)
    cancelled = bool(p["cancel_at"]) and len(calls) >= p["cancel_at"]
    known = fused_differs_from_progress(img, opts)
    if cross and not cancelled and not known:
        check_result("progress vs one device", got, res)
    ran["progress"] = 1
    ran["cancelled"] = int(cancelled)
    ran["c2"] = int(known)

    r, c = case["grid"]
    why = grid_refusal(img, opts, r, c)
    if why is None:
        out = engine._smooth_on_shards(img, opts, sharded.Shards(
            engine.shard_layout([dev] * (r * c), (r, c))))
        if out is None:
            why = "_smooth_on_shards declines (planes not aligned)"
        else:
            check_result(f"grid {r}x{c}", out, want)
            if cross:
                check_result(f"grid {r}x{c} vs one device", out, res)
            ran["grid"] = 1
    if why is not None:
        ran["skipped"] = f"grid {r}x{c} skipped: {why}"

    if case["batch"]:
        imgs = [img] + [build_image(case, seed=case["seed"] + k,
                                    damaged=False)
                        for k in range(1, case["batch"])]
        got = batch.smooth_image_batch(imgs, opts, device=dev)
        wants = oracle.image_batch(imgs, opts)
        for k, im in enumerate(imgs):
            check_result(f"batch image {k}", got[k], wants[k])
            check_result(f"batch image {k} vs one image", got[k],
                         want if k == 0 else oracle.smooth(im, opts))
            if cross:
                check_result(f"batch image {k} vs one image on the device",
                             got[k], res if k == 0
                             else engine.smooth(im, opts, dev))
        ran["batch"] = 1
        if len(img.components) == 1:
            coefs = np.stack([im.components[0].coefs for im in imgs])
            qtbl = img.components[0].quantval
            check_array("plane batch", "planes",
                        batch.smooth_plane_batch(coefs, qtbl, opts.flags,
                                                 opts.niter, True,
                                                 device=dev),
                        oracle.plane_batch(coefs, qtbl, opts.flags,
                                           opts.niter))
            ran["plane_batch"] = 1

    if case["decode"]:
        check_array("decode", "pixels", engine._decode_native(img, res, dev),
                    oracle.decode(img, want))
        ran["decode"] = 1

    if case.get("transcode"):
        # two more files of the case's geometry (one batch of the corpus
        # pipeline) and one of another width (a per-image leftover)
        datas = [jpeg_data(case), jpeg_data(case, case["seed"] + 1),
                 jpeg_data(case, case["seed"] + 2),
                 jpeg_data(case, case["seed"] + 3, case["w"] + 8)]
        _coef_files("smooth_many", batch.smooth_many(datas, opts,
                                                     device=dev),
                    oracle.smooth_many(datas, opts))
        _coef_files("smooth_jpeg_bytes",
                    [engine.smooth_jpeg_bytes(d, opts, device=dev)
                     for d in datas],
                    [oracle.smooth_jpeg_bytes(d, opts) for d in datas])
        ran["transcode"] = 1
    return ran


# ---------------------------------------------------------------------------
# The golden file: jpegqs_tpu's digests of fixed synth cases
# ---------------------------------------------------------------------------

def golden_cases():
    """The golden file's cases: synth cases of GOLDEN_SEED at most
    GOLDEN_MAX_HW pixels a side and GOLDEN_MAX_NITER iterations."""
    return [dict(c, niter=min(c["niter"], GOLDEN_MAX_NITER)) for c in (
        sample_case(GOLDEN_SEED, i, "synth", GOLDEN_MAX_HW)
        for i in range(GOLDEN_CASES))]


def write_golden(path):
    """The golden file from jpegqs_tpu (CPU mode): each entry the case and
    the digest (chip_smoke.digest) of jpegqs_tpu's output; every 4th
    entry whose layout the device decode takes also the digest of its
    decoded pixels (chip_smoke.pixel_digest)."""
    jax = JaxOracle()
    entries = []
    for i, case in enumerate(golden_cases()):
        img = build_image(case)
        res = jax.smooth(img, case_opts(case))
        entry = {"case": case,
                 "digest": digest(res.coefs, res.stop, res.upsampled)}
        if i % 4 == 0:
            px = jax.decode(img, res)
            if px is not None:
                entry["pixel_digest"] = pixel_digest(px)
        entries.append(entry)
    with open(path, "w") as f:
        json.dump({"what": "SHA-256 digests of jpegqs_tpu.engine.smooth "
                           "(chip_smoke.digest) and of its decoded pixels "
                           "(chip_smoke.pixel_digest) on the cases of "
                           "tools/fuzz_port.sample_case",
                   "seed": GOLDEN_SEED, "entries": entries}, f, indent=1)
        f.write("\n")
    return len(entries)


def load_golden(path=GOLDEN_PATH):
    with open(path) as f:
        return json.load(f)["entries"]


def replay_golden(device, path=GOLDEN_PATH, progress=True):
    """Every golden entry on ``device``: the fused path's digest, with
    ``progress`` the progress path's too (a counting callback, per
    iteration or in row chunks as the case draws; no cancel, so the
    output is the fused one), and the decoded pixels' where recorded.
    Raises Mismatch; returns the number of entries."""
    entries = load_golden(path)
    for entry in entries:
        case = entry["case"]
        img, opts = build_image(case), case_opts(case)
        runs = [("golden fused", opts)]
        if progress:
            runs.append(("golden progress", QsOptions(
                flags=opts.flags, niter=opts.niter,
                progprec=case["progress"]["progprec"],
                progress=recorder()[1], precise=case["progress"]["precise"])))
        for path_name, o in runs:
            res = engine.smooth(img, o, device)
            got = digest(res.coefs, res.stop, res.upsampled)
            if got != entry["digest"]:
                raise Mismatch(path_name, "digest",
                               f"{got} != {entry['digest']} for {case}")
        if "pixel_digest" in entry:
            got = pixel_digest(engine._decode_native(img, res, device))
            if got != entry["pixel_digest"]:
                raise Mismatch("golden decode", "pixel digest",
                               f"{got} != {entry['pixel_digest']} for "
                               f"{case}")
    return len(entries)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

class CaseFailure(Exception):
    """A case failed: its repro line leads the message."""


def repro(device, seed, i):
    return f"python tools/fuzz_port.py --device {device} --seed {seed} " \
           f"--case {i}"


def fuzz(device, seed, cases=None, seconds=None, only=None, log=print):
    """The fuzz loop: in card mode the golden replay first, then cases 0,
    1, ... of ``seed`` -- or only case ``only``, with no replay -- until
    ``cases`` ran or ``seconds`` of wall time passed since the first.
    ``log`` takes each case's line (None: quiet).  Raises CaseFailure on
    the first mismatch or error.  Returns the counts."""
    card = torch.device(device).type == "cuda"
    oracle = PortCpuOracle() if card else JaxOracle()
    sources = ("synth",) if card else ("synth", "jpeg")
    stats = {"cases": 0, "golden": 0, "golden_s": 0.0, "skipped": 0,
             **{k: 0 for k in PATHS + ("cancelled", "c2", "plane_batch",
                                       "transcode")}}
    if card and only is None:
        t0 = time.perf_counter()
        stats["golden"] = replay_golden(device)
        stats["golden_s"] = time.perf_counter() - t0
        if log:
            log(f"golden: {stats['golden']} entries of "
                f"{os.path.relpath(GOLDEN_PATH, REPO)} reproduced "
                f"({stats['golden_s']:.1f} s)")
    t00 = time.perf_counter()
    for i in ([only] if only is not None else range(cases or 1 << 30)):
        if seconds is not None and time.perf_counter() - t00 >= seconds:
            break
        case = sample_case(seed, i, sources[i % len(sources)])
        t0 = time.perf_counter()
        try:
            ran = run_case(case, device, oracle)
        except Mismatch as e:
            raise CaseFailure(
                f"{repro(device, seed, i)}\n[{i}] MISMATCH path {e.path}, "
                f"{e.what}: first mismatch {e.detail} against "
                f"{oracle.name}\ncase {json.dumps(case)}") from e
        except Exception as e:
            raise CaseFailure(
                f"{repro(device, seed, i)}\n[{i}] FAIL "
                f"{type(e).__name__}: {e}\ncase {json.dumps(case)}") from e
        stats["cases"] += 1
        for k, v in ran.items():
            if k == "skipped":
                stats[k] += v is not None
            else:
                stats[k] += v
        if log:
            names = [k for k in PATHS + ("plane_batch", "transcode")
                     if ran.get(k)]
            log(f"[{i}] ok {time.perf_counter() - t0:5.2f}s "
                f"{','.join(names)} {json.dumps(case)}")
            if ran["skipped"]:
                log(f"[{i}] {ran['skipped']}")
        if (i + 1) % CLEAR_EVERY == 0:
            oracle.clear()
    stats["seconds"] = time.perf_counter() - t00
    return stats


def paths_line(stats) -> str:
    return (f"fused {stats['fused']}, progress {stats['progress']} "
            f"({stats['cancelled']} cancelled, {stats['c2']} with C2's "
            f"difference from the fused path), grid {stats['grid']} "
            f"({stats['skipped']} skipped), batch {stats['batch']} "
            f"({stats['plane_batch']} plane batches), decode "
            f"{stats['decode']}, transcode {stats['transcode']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Differential fuzz of jpegqs_tpu_torch: the card's "
                    "kernels against the port's CPU run (--device cuda, "
                    "the default), or the port's CPU run against "
                    "jpegqs_tpu (--device cpu).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--cases", type=int, default=None,
                    help="number of cases (default 60 unless --seconds)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="sample cases until this much wall time passed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--case", type=int, default=None,
                    help="rerun only this case of --seed (the repro)")
    ap.add_argument("--write-golden", metavar="PATH", default=None,
                    help="CPU mode: write the golden file from jpegqs_tpu")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("fuzz_port: no CUDA device; card mode runs on the card only "
              "(--device cpu runs the oracle mode)", file=sys.stderr)
        return 2
    if dev.type not in ("cuda", "cpu"):
        print(f"fuzz_port: unsupported device {dev}", file=sys.stderr)
        return 2
    if dev.type == "cpu" and "jax" not in sys.modules:
        import_jax()
        from jpegqs_tpu.utils import cache
        cache.setup(os.path.join(REPO, ".jax_cache"))
    if args.write_golden:
        if dev.type != "cpu":
            print("fuzz_port: --write-golden needs --device cpu "
                  "(jpegqs_tpu computes the digests)", file=sys.stderr)
            return 2
        n = write_golden(args.write_golden)
        print(f"wrote {n} entries to {args.write_golden}")
        return 0
    cases = args.cases
    if cases is None and args.seconds is None:
        cases = 60
    t00 = time.perf_counter()
    try:
        stats = fuzz(args.device, args.seed, cases=cases,
                     seconds=args.seconds, only=args.case)
    except CaseFailure as e:
        print(e, flush=True)
        return 1
    print(f"ALL {stats['cases']} CASES BIT-EXACT "
          f"({(time.perf_counter() - t00) / 60:.1f} min, seed {args.seed}, "
          f"paths: {paths_line(stats)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
