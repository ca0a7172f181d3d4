#!/usr/bin/env python3
"""Where the host time of the port's batch engine goes, on one CUDA card.

Run from the repository root:

    python3 tools/time_batch_host.py

On 8 distinct 12 MP 4:2:0 photos at q6 n3 and 16 distinct 2.1 MP gray
frames at q3 n3 (jpegqs_tpu_torch/synth.py, IJG q75), medians of 3 on the
host clock, each stage synchronized: smooth_image_batch() and the same
images one smooth() at a time; the upload (engine.upload, pinned
staging) beside np.stack + a pageable copy; the dispatch of
engine.run_image and the wait for the card; the download through pinned
staging (engine.download) beside a pageable .cpu(); and the page faults of
a fresh host array of the outputs' size.  The card's name and power
limit head the output.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from jpegqs_tpu_torch import QsOptions, batch, engine, synth  # noqa: E402


def timed(fn, reps=3):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stages(name, imgs, quality, dev):
    opts = QsOptions.from_quality(quality, 3)
    plan = engine.plan_image(imgs[0], opts)
    n = len(imgs)
    rows = {
        "smooth_image_batch()": timed(
            lambda: batch.smooth_image_batch(imgs, opts)),
        "smooth() one image at a time": timed(
            lambda: [engine.smooth(im, opts) for im in imgs]),
        "upload: engine.upload (pinned staging)": timed(
            lambda: engine.upload(imgs, plan.comps, dev)),
        "upload: np.stack + pageable copy": timed(
            lambda: [torch.from_numpy(np.stack([
                im.components[p.ci].coefs.reshape(-1, 64) for im in imgs])
            ).to(dev) for p in plan.comps]),
    }
    inputs = engine.upload(imgs, plan.comps, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, _, ups = engine.run_image(plan, inputs, n)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    rows["run_image: dispatch"] = (t1 - t0) * 1e3
    rows["run_image: wait for the card"] = (time.perf_counter() - t1) * 1e3
    tensors = list(outs) + list(ups.values())
    mb = sum(t.numel() * t.element_size() for t in tensors) / 1e6
    rows[f"download {mb:.0f} MB: engine.download (pinned staging)"] = timed(
        lambda: engine.download(tensors)())
    rows[f"download {mb:.0f} MB: pageable .cpu()"] = timed(
        lambda: [t.cpu().numpy() for t in tensors])

    def fresh():
        a = np.empty(int(mb * 1e6) // 2, np.int16)
        a[::2048] = 1       # one write per 4 KB page
        return a
    rows[f"page faults of a fresh {mb:.0f} MB array"] = timed(fresh)
    for k, v in rows.items():
        print(f"{name}: {k}: {v:.3f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_batch_host: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    colors = [synth.make_image(3000, 4000, color=True, seed=s)
              for s in range(8)]
    stages("8 x 12 MP 4:2:0 q6 n3", colors, 6, dev)
    del colors
    grays = [synth.make_image(1080, 1920, seed=s) for s in range(16)]
    stages("16 x 2.1 MP gray q3 n3", grays, 3, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
