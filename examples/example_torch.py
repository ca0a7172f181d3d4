#!/usr/bin/env python
"""Library-consumer example of the PyTorch/CUDA port: decode a JPEG with
smoothing to a BMP.

The port's copy of examples/example.py, the Python analogue of the
reference's example.c (bitmap_read_jpeg + bitmap_save, example.c:78-185):
read JPEG -> smooth at the coefficient level -> decode to pixels -> write
a 24-bit BMP, with a progress callback.  It runs on the card unless
``--backend cpu`` is given (the plain PyTorch versions), and imports
nothing of jpegqs_tpu.  It reads the JPEG file through the port's libjpeg
codec (host/jpegio.py, built on first use), so it runs only where
libjpeg's headers are installed: the H100 machine that runs chip_smoke.py
has none, so this example cannot run there (chip_smoke.py builds its
inputs in numpy instead).

    python examples/example_torch.py [--backend cuda|cpu] input.jpg \\
        output.bmp [quality] [niter]
"""

import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from jpegqs_tpu_torch import QsOptions, decode_smoothed


def write_bmp(path, pix):
    """Minimal 24-bit BMP writer (like example.c:33-76)."""
    if pix.ndim == 2:
        pix = pix[:, :, None].repeat(3, axis=2)
    h, w, _ = pix.shape
    row = (w * 3 + 3) & ~3
    size = 54 + row * h
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                            row * h, 2835, 2835, 0, 0))
        pad = b"\0" * (row - w * 3)
        for y in range(h - 1, -1, -1):  # bottom-up, BGR
            f.write(pix[y, :, ::-1].tobytes() + pad)


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    backend = "cuda"
    if "--backend" in args:
        k = args.index("--backend")
        backend = args[k + 1] if k + 1 < len(args) else ""
        del args[k:k + 2]
    if len(args) < 2 or backend not in ("cuda", "cpu"):
        print(__doc__)
        return 1
    quality = int(args[2]) if len(args) > 2 else 3
    niter = int(args[3]) if len(args) > 3 else 3

    def progress(userdata, cur, total):
        print(f"\rprogress: {100 * cur // total}%", end="", flush=True)
        return 0  # return 1 to cancel

    opts = QsOptions.from_quality(quality, niter, progress=progress)
    with open(args[0], "rb") as f:
        pix = decode_smoothed(f.read(), opts, device=backend)
    print()
    write_bmp(args[1], pix)
    print(f"wrote {args[1]}: {pix.shape[1]}x{pix.shape[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
