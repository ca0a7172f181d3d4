"""jpegqs_tpu_torch -- the PyTorch/CUDA port of jpegqs_tpu.

Quantization-constrained JPEG restoration (the capabilities of
ilyakurdyukov/jpeg-quantsmooth) with its solver running as CUDA kernels
written for Hopper (csrc/solver.cu).  Bit-identical to the JAX package
``jpegqs_tpu`` at every quality level, q0-q6, on gray and YCbCr colour
at any sampling factors, with or without a progress callback (per
iteration, or per row chunk with ``precise``; a truthy return
cancels).  With more than one CUDA device and no callback, ``smooth``
shards a large image's block rows over every device
(parallel/sharded.py).  The batch engine (batch.py) runs many same-shape
images as one block axis through the same kernels, and
``decode_smoothed`` decodes the smoothed planes to pixels on the device.
Sharding also runs on a rows x columns grid, over a data x row layout
for batches and across processes (parallel/multihost.py).  It imports
neither JAX nor anything of ``jpegqs_tpu``.

Public API:
  smooth(img, opts, device=None)            -- coefficient-level engine
  smooth_jpeg_bytes(data, opts, optimize, device)
                                            -- JPEG bytes -> smoothed JPEG
  decode_smoothed(data, opts, device)       -- JPEG bytes -> smoothed pixels
  smooth_many(datas, opts, workers, optimize, device)
                                            -- a corpus of JPEG bytes
  smooth_plane_batch(coefs, qtbl, flags, niter, luma, device)
                                            -- N same-shape gray planes
  smooth_image_batch(imgs, opts, device)    -- N same-shape images
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
    "decode_smoothed", "smooth_many", "smooth_plane_batch",
    "smooth_image_batch",
]


def smooth(img, opts, device=None):
    from . import engine
    return engine.smooth(img, opts, device)


def smooth_jpeg_bytes(data, opts=None, optimize=False, device=None):
    from . import engine
    return engine.smooth_jpeg_bytes(data, opts, optimize, device)


def decode_smoothed(data, opts=None, device=None):
    from . import engine
    return engine.decode_smoothed(data, opts, device)


def smooth_many(datas, opts=None, workers=4, optimize=False, device=None):
    from . import batch
    return batch.smooth_many(datas, opts, workers, optimize, device)


def smooth_plane_batch(coefs, qtbl, flags, niter, luma=True, device=None):
    from . import batch
    return batch.smooth_plane_batch(coefs, qtbl, flags, niter, luma, device)


def smooth_image_batch(imgs, opts=None, device=None):
    from . import batch
    return batch.smooth_image_batch(imgs, opts, device)
