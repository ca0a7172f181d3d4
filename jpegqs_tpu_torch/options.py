"""Engine options — mirrors the reference flag system.

Flag values follow the reference enum (reference: libjpegqs.h:14-32) and
the CLI quality ladder (reference: quantsmooth.c:380-393).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

# Algorithm flags (reference: libjpegqs.h:16-23)
DIAGONALS = 1
JOINT_YUV = 2
UPSAMPLE_UV = 4
LOW_QUALITY = 8
NO_REBALANCE = 16
NO_REBALANCE_UV = 32
TRANSCODE = 64
FLAGS_MASK = 0x7F

ITER_MAX = 100  # reference: libjpegqs.h:15

# Info flags (reference: libjpegqs.h:26-31)
INFO_SHIFT = 16
INFO_COMP1 = 1 << INFO_SHIFT
INFO_QUANT = 2 << INFO_SHIFT
INFO_COMP2 = 4 << INFO_SHIFT
INFO_TIME = 8 << INFO_SHIFT


def quality_to_flags(quality: int) -> int:
    """Expand the 0-6 quality ladder to algorithm flags.

    Reference: quantsmooth.c:380-393.  q<3 selects the LOW_QUALITY path
    and is then treated as q+4, so q0->LQ+DIAGONALS, q1 adds JOINT_YUV,
    q2 adds UPSAMPLE_UV; q4/5/6 add DIAGONALS/JOINT_YUV/UPSAMPLE_UV.
    """
    flags = 0
    if quality < 3:
        flags |= LOW_QUALITY
        quality += 4
    if quality >= 4:
        flags |= DIAGONALS
    if quality >= 5:
        flags |= JOINT_YUV
    if quality >= 6:
        flags |= UPSAMPLE_UV
    return flags


@dataclass
class QsOptions:
    """Control options, the analogue of jpegqs_control_t (libjpegqs.h:41-45).

    ``threads`` is kept for CLI compatibility but has no effect on the
    device (it runs all blocks in parallel); ``progress`` is called
    between device steps with (userdata, cur, max) and may return truthy
    to cancel, like the reference callback.

    ``precise``: per-block-row progress resolution — the analogue of
    the reference's -DPRECISE_PROGRESS build option
    (quantsmooth.h:2632-2665 atomic row counter): iterations are
    chunked on the block-row axis so the callback fires (and can
    cancel) mid-iteration whenever ``progprec`` demands sub-iteration
    resolution.  Default off, matching the reference's default build.
    """
    flags: int = 0
    niter: int = 3
    threads: int = 0
    progprec: int = 0
    userdata: object = None
    progress: Optional[Callable] = None
    precise: bool = False

    @classmethod
    def from_quality(cls, quality: int = 3, niter: int = 3, **kw) -> "QsOptions":
        return cls(flags=quality_to_flags(quality), niter=niter, **kw)
