"""Host-side JPEG coefficient I/O.

Wraps the native ``libqshost.so`` runtime (built from ``csrc/qshost.c``)
via ctypes.  Entropy decode/encode stays on the host, exactly as in the
reference architecture (reference: quantsmooth.c:548-579) — the engine
only ever sees int16 coefficient planes and uint16 quant tables.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass, field

import numpy as np

DCTSIZE = 8
DCTSIZE2 = 64
JCS_YCBCR = 3  # libjpeg J_COLOR_SPACE value

_CSRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_LIB_PATH = os.path.join(_CSRC_DIR, "libqshost.so")


class _QsInfo(ctypes.Structure):
    _fields_ = [
        ("image_width", ctypes.c_int32),
        ("image_height", ctypes.c_int32),
        ("num_components", ctypes.c_int32),
        ("jpeg_color_space", ctypes.c_int32),
        ("progressive_mode", ctypes.c_int32),
        ("max_h_samp_factor", ctypes.c_int32),
        ("max_v_samp_factor", ctypes.c_int32),
        ("num_warnings", ctypes.c_int32),
    ]


class _QsCompInfo(ctypes.Structure):
    _fields_ = [
        ("component_id", ctypes.c_int32),
        ("h_samp_factor", ctypes.c_int32),
        ("v_samp_factor", ctypes.c_int32),
        ("quant_tbl_no", ctypes.c_int32),
        ("width_in_blocks", ctypes.c_int32),
        ("height_in_blocks", ctypes.c_int32),
        ("quantval", ctypes.c_uint16 * DCTSIZE2),
    ]


_lib = None


def _build_lib() -> None:
    subprocess.run(["make", "-C", _CSRC_DIR], check=True, capture_output=True)


def get_lib() -> ctypes.CDLL:
    """Load (building on first use) the native host runtime."""
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_CSRC_DIR, "qshost.c")
    if not os.path.exists(_LIB_PATH) or (
        os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    ):
        _build_lib()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.qs_open.restype = ctypes.c_void_p
    lib.qs_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                            ctypes.c_int]
    lib.qs_num_warnings.restype = ctypes.c_int32
    lib.qs_num_warnings.argtypes = [ctypes.c_void_p]
    lib.qs_ok.restype = ctypes.c_int
    lib.qs_ok.argtypes = [ctypes.c_void_p]
    lib.qs_error.restype = ctypes.c_char_p
    lib.qs_error.argtypes = [ctypes.c_void_p]
    lib.qs_get_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(_QsInfo)]
    lib.qs_get_comp_info.restype = ctypes.c_int
    lib.qs_get_comp_info.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(_QsCompInfo)]
    lib.qs_read_coefs.restype = ctypes.c_int
    lib.qs_read_coefs.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.qs_write_coefs.restype = ctypes.c_int
    lib.qs_write_coefs.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.qs_set_upsampled.restype = ctypes.c_int
    lib.qs_set_upsampled.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.qs_save.restype = ctypes.c_int
    lib.qs_save.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_size_t)]
    lib.qs_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.qs_close.argtypes = [ctypes.c_void_p]
    lib.qs_encode.restype = ctypes.c_int
    lib.qs_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                              ctypes.POINTER(ctypes.c_size_t)]
    lib.qs_decode.restype = ctypes.c_int
    lib.qs_decode.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                              ctypes.POINTER(ctypes.c_int32),
                              ctypes.POINTER(ctypes.c_int32),
                              ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


@dataclass
class ComponentData:
    """One JPEG component's coefficient plane and metadata."""
    component_id: int
    h_samp_factor: int
    v_samp_factor: int
    quant_tbl_no: int
    width_in_blocks: int
    height_in_blocks: int
    quantval: np.ndarray  # uint16[64], natural order
    coefs: np.ndarray     # int16[height_in_blocks, width_in_blocks, 64], natural order


@dataclass
class JpegImage:
    """A decoded-to-coefficients JPEG, the engine's input/output unit."""
    width: int
    height: int
    jpeg_color_space: int
    progressive: bool
    max_h_samp_factor: int
    max_v_samp_factor: int
    components: list = field(default_factory=list)

    @property
    def is_ycbcr(self) -> bool:
        return self.jpeg_color_space == JCS_YCBCR

    @property
    def num_components(self) -> int:
        return len(self.components)


class JpegCoefFile:
    """Handle to an open JPEG held at the coefficient level.

    Mirrors the reference transcode flow: read coefficients, let the
    engine mutate them, re-encode with quant tables forced to 1.
    """

    def __init__(self, data: bytes, copy_markers: int = 2, verbose: int = 0):
        self._lib = get_lib()
        self._h = self._lib.qs_open(data, len(data), copy_markers, verbose)
        if not self._h:
            raise MemoryError("qs_open failed")
        if not self._lib.qs_ok(self._h):
            msg = self._lib.qs_error(self._h).decode("utf-8", "replace")
            self._lib.qs_close(self._h)
            self._h = None
            raise ValueError(f"JPEG parse error: {msg}")

    def read(self) -> JpegImage:
        info = _QsInfo()
        self._lib.qs_get_info(self._h, ctypes.byref(info))
        img = JpegImage(
            width=info.image_width,
            height=info.image_height,
            jpeg_color_space=info.jpeg_color_space,
            progressive=bool(info.progressive_mode),
            max_h_samp_factor=info.max_h_samp_factor,
            max_v_samp_factor=info.max_v_samp_factor,
        )
        for ci in range(info.num_components):
            cinfo = _QsCompInfo()
            if self._lib.qs_get_comp_info(self._h, ci, ctypes.byref(cinfo)) != 0:
                raise ValueError(f"bad component {ci}")
            coefs = np.empty(
                (cinfo.height_in_blocks, cinfo.width_in_blocks, DCTSIZE2),
                dtype=np.int16)
            if self._lib.qs_read_coefs(self._h, ci,
                                       coefs.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise ValueError(f"coef read failed for component {ci}")
            img.components.append(ComponentData(
                component_id=cinfo.component_id,
                h_samp_factor=cinfo.h_samp_factor,
                v_samp_factor=cinfo.v_samp_factor,
                quant_tbl_no=cinfo.quant_tbl_no,
                width_in_blocks=cinfo.width_in_blocks,
                height_in_blocks=cinfo.height_in_blocks,
                quantval=np.array(cinfo.quantval, dtype=np.uint16),
                coefs=coefs,
            ))
        return img

    def write_coefs(self, ci: int, coefs: np.ndarray) -> None:
        coefs = np.ascontiguousarray(coefs, dtype=np.int16)
        if self._lib.qs_write_coefs(self._h, ci,
                                    coefs.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise ValueError(f"coef write failed for component {ci}")

    def set_upsampled(self, cb: np.ndarray, cr: np.ndarray) -> None:
        """Replace chroma planes with full-resolution coefficients (UPSAMPLE_UV)."""
        cb = np.ascontiguousarray(cb, dtype=np.int16)
        cr = np.ascontiguousarray(cr, dtype=np.int16)
        if self._lib.qs_set_upsampled(
                self._h,
                cb.ctypes.data_as(ctypes.c_void_p),
                cr.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise ValueError("set_upsampled failed")

    def save(self, optimize: bool = False, set_qtable_one: bool = True) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_size = ctypes.c_size_t()
        if self._lib.qs_save(self._h, int(optimize), int(set_qtable_one),
                             ctypes.byref(out), ctypes.byref(out_size)) != 0:
            msg = self._lib.qs_error(self._h).decode("utf-8", "replace")
            raise ValueError(f"JPEG save error: {msg}")
        try:
            return ctypes.string_at(out, out_size.value)
        finally:
            self._lib.qs_free_buf(out)

    def num_warnings(self) -> int:
        """Total libjpeg corrupt-data warnings (decode + saves) — drives
        the reference-compatible exit code 2 (quantsmooth.c:626)."""
        return int(self._lib.qs_num_warnings(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.qs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_coefficients(data: bytes) -> JpegImage:
    """One-shot: parse a JPEG and return its coefficient-level representation."""
    with JpegCoefFile(data) as f:
        return f.read()


def encode_pixels(pixels: np.ndarray, quality: int = 75, subsamp: int = 1,
                  progressive: bool = False, arith: bool = False,
                  restart_interval: int = 0) -> bytes:
    """Encode uint8 pixels (H,W) gray, (H,W,3) RGB or (H,W,4) CMYK to
    JPEG bytes.  ``arith`` selects arithmetic entropy coding;
    ``restart_interval`` emits DRI/RSTn markers every N MCUs."""
    lib = get_lib()
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim == 2:
        h, w = pixels.shape
        ncomp = 1
    else:
        h, w, ncomp = pixels.shape
        if ncomp not in (3, 4):
            raise ValueError("expected gray, RGB or CMYK pixels")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    if lib.qs_encode(pixels.ctypes.data_as(ctypes.c_void_p), w, h, ncomp,
                     quality, subsamp, int(progressive), int(arith),
                     int(restart_interval),
                     ctypes.byref(out), ctypes.byref(out_size)) != 0:
        raise ValueError("encode failed")
    try:
        return ctypes.string_at(out, out_size.value)
    finally:
        lib.qs_free_buf(out)


def decode_pixels(data: bytes) -> np.ndarray:
    """Decode a JPEG to uint8 pixels (H,W) or (H,W,3)."""
    lib = get_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    ncomp = ctypes.c_int32()
    if lib.qs_decode(data, len(data), ctypes.byref(out),
                     ctypes.byref(w), ctypes.byref(h), ctypes.byref(ncomp)) != 0:
        raise ValueError("decode failed")
    try:
        arr = np.frombuffer(
            ctypes.string_at(out, w.value * h.value * ncomp.value),
            dtype=np.uint8).copy()
    finally:
        lib.qs_free_buf(out)
    if ncomp.value == 1:
        return arr.reshape(h.value, w.value)
    return arr.reshape(h.value, w.value, ncomp.value)


def image_from_arrays(other) -> JpegImage:
    """Build this package's JpegImage from any object with the same
    fields (duck-typed: another package's JpegImage, a test fixture),
    copying every array as numpy.  Lets two engines be fed the very
    same decoded image without one package importing the other."""
    img = JpegImage(
        width=int(other.width),
        height=int(other.height),
        jpeg_color_space=int(other.jpeg_color_space),
        progressive=bool(other.progressive),
        max_h_samp_factor=int(other.max_h_samp_factor),
        max_v_samp_factor=int(other.max_v_samp_factor),
    )
    for c in other.components:
        img.components.append(ComponentData(
            component_id=int(c.component_id),
            h_samp_factor=int(c.h_samp_factor),
            v_samp_factor=int(c.v_samp_factor),
            quant_tbl_no=int(c.quant_tbl_no),
            width_in_blocks=int(c.width_in_blocks),
            height_in_blocks=int(c.height_in_blocks),
            quantval=np.array(c.quantval, dtype=np.uint16),
            coefs=np.array(c.coefs, dtype=np.int16),
        ))
    return img
