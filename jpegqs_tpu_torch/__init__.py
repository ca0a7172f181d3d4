"""jpegqs_tpu_torch -- the PyTorch/CUDA port of jpegqs_tpu.

Quantization-constrained JPEG restoration (the capabilities of
ilyakurdyukov/jpeg-quantsmooth) with its solver running as CUDA kernels
written for Hopper (csrc/solver.cu).  Bit-identical to the JAX package
``jpegqs_tpu`` at every quality level, q0-q6, on gray and YCbCr colour
at any sampling factors, with or without a progress callback (per
iteration, or per row chunk with ``precise``; a truthy return
cancels).  With more than one CUDA device and no callback, ``smooth``
shards a large image's block rows over every device
(parallel/sharded.py).  Batching, the 2-D shard grid, multi-process
sharding and ``decode_smoothed`` are not ported yet.  It imports neither
JAX nor anything of ``jpegqs_tpu``.

Public API:
  smooth(img, opts, device=None)            -- coefficient-level engine
  smooth_jpeg_bytes(data, opts, optimize, device)
                                            -- JPEG bytes -> smoothed JPEG
  QsOptions / quality_to_flags / flags      -- option surface
  host.jpegio                               -- host-side entropy codec
Entry points run on the card (``cuda``) unless ``device="cpu"``.
"""

from .options import (QsOptions, quality_to_flags, DIAGONALS, JOINT_YUV,
                      UPSAMPLE_UV, LOW_QUALITY, NO_REBALANCE,
                      NO_REBALANCE_UV, TRANSCODE, ITER_MAX)

__version__ = "0.1.0"

__all__ = [
    "QsOptions", "quality_to_flags", "DIAGONALS", "JOINT_YUV",
    "UPSAMPLE_UV", "LOW_QUALITY", "NO_REBALANCE", "NO_REBALANCE_UV",
    "TRANSCODE", "ITER_MAX", "smooth", "smooth_jpeg_bytes",
]


def smooth(img, opts, device=None):
    from . import engine
    return engine.smooth(img, opts, device)


def smooth_jpeg_bytes(data, opts=None, optimize=False, device=None):
    from . import engine
    return engine.smooth_jpeg_bytes(data, opts, optimize, device)
