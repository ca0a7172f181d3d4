"""The system under test and the closed loop that drives it.

``Program`` wraps ``jpegqs_tpu_torch.batch.dispatch_image_batch`` and
the ``assemble()`` it returns, the calls ``smooth_corpus`` makes for each
batch, without the entropy codec.

``run_loop`` keeps up to ``window`` batches in flight and dispatches a
new one as soon as the oldest has been assembled.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

class Program:
    """The program (``jpegqs_tpu_torch``) on ``device`` under the
    configuration's options."""

    def __init__(self, cfg: dict, device):
        import jpegqs_tpu_torch
        from jpegqs_tpu_torch import batch, engine
        from jpegqs_tpu_torch.host.jpegio import (ComponentData, JpegImage,
                                                  JCS_YCBCR)
        self._batch = batch
        self._types = (ComponentData, JpegImage, JCS_YCBCR)
        self.device = engine.resolve_device(device)
        self.opts = jpegqs_tpu_torch.QsOptions.from_quality(cfg["quality"],
                                                            cfg["niter"])

    def prepare(self, photo):
        """The harness's photo as the program's input, a JpegImage."""
        ComponentData, JpegImage, JCS_YCBCR = self._types
        img = JpegImage(width=photo.width, height=photo.height,
                        jpeg_color_space=JCS_YCBCR,
                        progressive=False,
                        max_h_samp_factor=photo.comps[0].h_samp,
                        max_v_samp_factor=photo.comps[0].v_samp)
        for c in photo.comps:
            img.components.append(ComponentData(
                component_id=c.component_id, h_samp_factor=c.h_samp,
                v_samp_factor=c.v_samp, quant_tbl_no=c.quant_tbl_no,
                width_in_blocks=c.wb, height_in_blocks=c.hb,
                quantval=c.quantval, coefs=c.coefs))
        return img

    def dispatch(self, imgs):
        """Queue one batch; returns ``assemble() -> results``, each with
        ``coefs``, ``upsampled`` and ``stop``."""
        return self._batch.dispatch_image_batch(imgs, self.opts,
                                                self.device)

    def synchronize(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


@dataclass
class Batch:
    number: int
    images: list            # pool indices
    t_dispatch: float       # host clock, s
    t_dispatched: float
    t_assemble: float = 0.0
    t_done: float = 0.0


@dataclass
class LoopRecord:
    t0: float
    t_end: float = 0.0
    done: list = field(default_factory=list)     # Batch, in the window
    drained: list = field(default_factory=list)  # Batch, after it
    kept: list = field(default_factory=list)     # (Batch, results)
    error: str = ""

    @property
    def dispatched(self):
        return self.done + self.drained


def batch_order(traffic: dict, seed: int):
    """Endless batches of ``batch_images`` distinct pool indices: each a
    fresh permutation of the pool, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    n, k = traffic["pool_images"], traffic["batch_images"]
    while True:
        yield [int(i) for i in rng.permutation(n)[:k]]


def run_loop(system, inputs, order, seconds, window, keep=0, seed=0,
             span=None):
    """Drive ``system`` for ``seconds`` with up to ``window`` batches in
    flight.  The window runs from the first dispatch to the first
    completion at or after ``seconds``; the batches still in flight are
    then assembled outside it.  ``keep`` completed batches of the window
    are kept with their results, a uniform sample drawn from ``seed``
    (reservoir sampling).  ``span(name)`` wraps each call in a
    profiler range when tracing."""
    span = span or (lambda name: contextlib.nullcontext())
    rng = np.random.default_rng([seed, 2])
    inflight = deque()
    rec = LoopRecord(t0=time.perf_counter())
    deadline = rec.t0 + seconds
    number = 0

    def finish(b, asm):
        b.t_assemble = time.perf_counter()
        with span("bench.assemble"):
            results = asm()
        b.t_done = time.perf_counter()
        return results

    try:
        while True:
            while len(inflight) < window:
                idx = next(order)
                t = time.perf_counter()
                with span("bench.dispatch"):
                    asm = system.dispatch([inputs[i] for i in idx])
                inflight.append((Batch(number, idx, t, time.perf_counter()),
                                 asm))
                number += 1
            b, asm = inflight.popleft()
            results = finish(b, asm)
            j = len(rec.done)
            rec.done.append(b)
            slot = j if j < keep else int(rng.integers(0, j + 1))
            if slot < keep:
                if slot == len(rec.kept):
                    rec.kept.append((b, results))
                else:
                    rec.kept[slot] = (b, results)
            del results
            if b.t_done >= deadline:
                break
        rec.t_end = rec.done[-1].t_done
        while inflight:
            b, asm = inflight.popleft()
            finish(b, asm)
            rec.drained.append(b)
    except Exception as e:          # reported as a failed run
        import traceback
        rec.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
        rec.t_end = time.perf_counter()
        inflight.clear()
    return rec
