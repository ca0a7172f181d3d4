"""The solver kernels' wrappers: the counterpart of
``jpegqs_tpu/ops/pallas_solver.py``.

The kernels of csrc/solver.cu:

- ``idct_pix``: the pixel bootstrap (B1), the islow IDCT of every block;
- ``solve_rebalance_pix``: one resident solver pass (B2): border lines
  from the previous pass's pixels, the k=63..1 sweep, the AC rebalance
  and the pixels of the result;
- ``solve_fused_pix``: one fused pass, B3 with the JOINT_YUV preamble
  (``image2`` given) or B4 with the LOW_QUALITY one: the 10x10 halo from
  the previous pass's pixels, the preamble and its FDCT + interval
  clamp, then B2's sweep unless LOW_QUALITY, the rebalance and the
  pixels;
- ``solve_rebalance`` (B5) and ``solve_fused`` (B6): the passes of B2
  and B3/B4 on a neighbourhood the caller materialised (border lines
  or 10x10 halos), the progress path's passes; they take row chunks of
  whole planes as column-slice views; B5 runs B2's kernel body, or on
  launches of few CTAs an SM its lane body (``use_lane_body``);
- ``solve_range_pix`` (B7): the pass of B2, B3 or B4 over a block range
  of a shard's ghost-extended grid, with the edges given by the caller,
  into a range of a whole-size output: the sharded resident loop's pass
  (parallel/sharded.py);
- ``peak_chains`` (T3): the card's fp32 peak probe, on no path.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(ops/dct.py, ops/planar.py, ``peak_chains_plain`` here); given CUDA
tensors it launches the kernel on the current stream or raises -- it
never falls back.  ``LAUNCHES`` counts kernel launches only (never
plain-version calls), so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..options import DIAGONALS, LOW_QUALITY
from ..specref import make_solver_tables
from . import _build
from .dct import idct_islow
from . import planar

LAUNCHES = {"idct_pix": 0, "solve_rebalance_pix": 0,
            "solve_fused_pix_joint": 0, "solve_fused_pix_lq": 0,
            "solve_rebalance": 0, "solve_rebalance_lanes": 0,
            "solve_fused_joint": 0,
            "solve_fused_lq": 0, "solve_range_pix": 0,
            "solve_range_pix_joint": 0, "solve_range_pix_lq": 0, "peak": 0}

_TAB_CACHE = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nt_for(flags: int) -> int:
    """Diff terms the sweep folds: without DIAGONALS the 98 diagonal
    terms have zero weight and cannot change the fold, so they are
    omitted."""
    return 242 if (flags & DIAGONALS) else 144


def solver_tables(flags: int, device) -> torch.Tensor:
    """f32[64, NT] solver tables on ``device`` (cached)."""
    nt = nt_for(flags)
    key = (nt, str(torch.device(device)))
    tab = _TAB_CACHE.get(key)
    if tab is None:
        host = np.ascontiguousarray(make_solver_tables(flags)[:, :nt])
        tab = torch.from_numpy(host).to(device)
        _TAB_CACHE[key] = tab
    return tab


def kernel_tables(flags: int, device) -> torch.Tensor:
    """The kernels' solver tables on ``device`` (cached): f32[64, pitch],
    ``solver_tables`` with its NT columns padded with zeros to a multiple
    of four (pitch 144 or 244), so that a kernel reads a row as float4;
    no kernel folds the pad."""
    tab = solver_tables(flags, device)
    nt = tab.shape[1]
    if nt % 4 == 0:
        return tab
    key = ("padded", nt, str(torch.device(device)))
    padded = _TAB_CACHE.get(key)
    if padded is None:
        padded = torch.zeros((64, nt + (-nt) % 4), dtype=tab.dtype,
                             device=tab.device)
        padded[:, :nt] = tab
        _TAB_CACHE[key] = padded
    return padded


def _kernel_tab(flags, sweep, device):
    """The table arguments of a launch: (pointer, NT, pitch) of
    ``kernel_tables``, or (None, 0, 0) for a pass without the sweep."""
    if not sweep:
        return None, 0, 0
    tab = kernel_tables(flags, device)
    return tab.data_ptr(), nt_for(flags), tab.shape[1]


def _is_cpu(*ts) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(str(t.device) for t in ts)}")


def _check(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype}{list(shape)}, "
                         f"got {t.dtype}{list(t.shape)} "
                         f"(contiguous={t.is_contiguous()})")


def _check_tables(div, x1, qshr):
    for name, t in (("div", div), ("x1", x1), ("qshr", qshr)):
        _check(t, torch.int32, (64,), name)


def _row_stride(t, rows, n, name):
    """The row stride of an int32[rows, n] view whose last stride is 1
    (a row chunk ``x[:, a:b]`` of a whole plane), passed to a kernel as
    its ``ld``."""
    ok = (t.dtype == torch.int32 and tuple(t.shape) == (rows, n)
          and (n <= 1 or t.stride(1) == 1) and n <= t.stride(0) < 2 ** 31)
    if not ok:
        raise ValueError(f"{name}: need int32[{rows}, {n}] with last stride "
                         f"1, got {t.dtype}{list(t.shape)} strides "
                         f"{t.stride()}")
    return t.stride(0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def idct_pix(coef):
    """Pixel bootstrap: coef int32[64, B] -> pixels int32[64, B] (the
    islow IDCT of every block; the coefficients are not changed)."""
    B = coef.shape[1]
    if _is_cpu(coef):
        return idct_islow(coef.reshape(8, 8, B)).reshape(64, B)
    _check(coef, torch.int32, (64, B), "coef")
    lib = _build.load()
    pix = torch.empty_like(coef)
    with torch.cuda.device(coef.device):
        err = lib.jq_idct_pix(coef.data_ptr(), pix.data_ptr(), B,
                              torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "idct_pix")
    LAUNCHES["idct_pix"] += 1
    return pix


def solve_rebalance_pix(coef, pix, div, x1, qshr, flags, do_rebalance, hb,
                        wb, want_pix=True):
    """One resident solver pass over all blocks of a component.

    coef, pix int32[64, B] (pix: the previous pass's pixels, from which
    the border lines are rebuilt); div/x1/qshr int32[64] from
    make_quant_tables.  B may hold several hb x wb images back to back.
    Returns (coef', pix') with pix' the IDCT of coef', or (coef', None)
    when ``want_pix`` is false (the last pass)."""
    B = coef.shape[1]
    tab = solver_tables(flags, coef.device)
    if _is_cpu(coef, pix, div, x1, qshr, tab):
        if B != hb * wb:
            raise ValueError("the plain version takes one image")
        return planar.solve_rebalance_pix(coef, pix, div, x1, qshr, tab,
                                          do_rebalance, hb, wb, want_pix)
    _check(coef, torch.int32, (64, B), "coef")
    _check(pix, torch.int32, (64, B), "pix")
    _check_tables(div, x1, qshr)
    if hb < 1 or wb < 1 or B % (hb * wb):
        raise ValueError(f"B={B} is not a multiple of hb*wb={hb * wb}")
    lib = _build.load()
    out = torch.empty_like(coef)
    pix_out = torch.empty_like(pix) if want_pix else None
    with torch.cuda.device(coef.device):
        err = lib.jq_solve_rebalance_pix(
            coef.data_ptr(), pix.data_ptr(), out.data_ptr(), _ptr(pix_out),
            div.data_ptr(), x1.data_ptr(), qshr.data_ptr(),
            *_kernel_tab(flags, True, coef.device), B, hb, wb,
            int(bool(do_rebalance)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "solve_rebalance_pix")
    LAUNCHES["solve_rebalance_pix"] += 1
    return out, pix_out


def solve_fused_pix(coef, pix, image2, div, x1, qshr, flags, do_rebalance,
                    hb, wb, want_pix=True):
    """One fused pass over all blocks of a component: B3 (JOINT_YUV
    preamble) when ``image2`` is given, else B4 (LOW_QUALITY preamble,
    which needs ``flags & LOW_QUALITY``); the sweep runs unless
    ``flags & LOW_QUALITY``.

    coef, pix int32[64, B] (pix: the previous pass's pixels, from which
    the 10x10 halo is rebuilt); image2 int32[100, B] the downsampled-luma
    halos (planar.blocks_halo10, flattened) or None; div/x1/qshr
    int32[64].  B may hold several hb x wb images back to back.
    Returns (coef', pix') or (coef', None) when ``want_pix`` is false."""
    B = coef.shape[1]
    if image2 is None and not flags & LOW_QUALITY:
        raise ValueError("a fused pass needs image2 (JOINT_YUV) or "
                         "LOW_QUALITY flags")
    sweep = not flags & LOW_QUALITY
    tab = solver_tables(flags, coef.device) if sweep else None
    ts = [t for t in (coef, pix, image2, div, x1, qshr, tab)
          if t is not None]
    if _is_cpu(*ts):
        return planar.solve_fused_pix(coef, pix, image2, div, x1, qshr, tab,
                                      flags, do_rebalance, hb, wb, want_pix)
    _check(coef, torch.int32, (64, B), "coef")
    _check(pix, torch.int32, (64, B), "pix")
    if image2 is not None:
        _check(image2, torch.int32, (100, B), "image2")
    _check_tables(div, x1, qshr)
    if hb < 1 or wb < 1 or B % (hb * wb):
        raise ValueError(f"B={B} is not a multiple of hb*wb={hb * wb}")
    lib = _build.load()
    out = torch.empty_like(coef)
    pix_out = torch.empty_like(pix) if want_pix else None
    with torch.cuda.device(coef.device):
        err = lib.jq_solve_fused_pix(
            coef.data_ptr(), pix.data_ptr(), _ptr(image2), out.data_ptr(),
            _ptr(pix_out), div.data_ptr(), x1.data_ptr(), qshr.data_ptr(),
            *_kernel_tab(flags, sweep, coef.device), B, hb, wb,
            int(bool(do_rebalance)), torch.cuda.current_stream().cuda_stream)
    name = ("solve_fused_pix_joint" if image2 is not None
            else "solve_fused_pix_lq")
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, pix_out


# B5 takes its lane body (csrc/solver.cu solve_borders_lanes_kernel) on
# launches of at most this many CTAs of 128 one-block threads per SM, B2's
# body above: where the two bodies' kernel-only times cross on the planes
# of tools/time_solver_kernels.py (b5_bodies_ms; NVIDIA H100 80GB HBM3,
# 700 W: lane body / B2's at m = 1, 1.25, 1.5 CTAs an SM 0.205 / 0.302,
# 0.26 / 0.30, 0.31 / 0.31 ms at NT 242, 0.163 / 0.19, 0.20 / 0.20,
# 0.22 / 0.21 at NT 144; PERF.md, Findings)
REBALANCE_LANES_CTAS_PER_SM = 1.25

_SMS = {}


def use_lane_body(n: int, sms: int) -> bool:
    """Whether a B5 launch of ``n`` blocks on a card of ``sms`` SMs takes
    the lane body: at most REBALANCE_LANES_CTAS_PER_SM CTAs of 128 blocks
    per SM."""
    return -(-n // 128) <= REBALANCE_LANES_CTAS_PER_SM * sms


def _sm_count(device) -> int:
    """The SM count of a CUDA device (asked once per device)."""
    key = torch.device(device).index or 0
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _SMS[key]


def solve_rebalance(coef, borders, div, x1, qshr, flags, do_rebalance,
                    want_pix=False, lanes=None):
    """One solver pass (B5) on given border lines: coef int32[64, n];
    borders int32[32, n] (top, bottom, left, right, eight rows each);
    div/x1/qshr int32[64].  coef and borders may be column-slice views
    of whole planes (a row chunk).  Returns (coef', pix') with pix' the
    IDCT of coef', or (coef', None) unless ``want_pix``; the outputs are
    new contiguous [64, n] tensors.  On the card the launch takes the
    lane body when ``lanes``, B2's body when not, and by
    ``use_lane_body`` when None."""
    n = coef.shape[1]
    tab = solver_tables(flags, coef.device)
    if _is_cpu(coef, borders, div, x1, qshr, tab):
        return planar.solve_rebalance(coef, borders, div, x1, qshr, tab,
                                      do_rebalance, want_pix)
    ld_coef = _row_stride(coef, 64, n, "coef")
    ld_borders = _row_stride(borders, 32, n, "borders")
    _check_tables(div, x1, qshr)
    if lanes is None:
        lanes = use_lane_body(n, _sm_count(coef.device))
    lib = _build.load()
    out = torch.empty((64, n), dtype=torch.int32, device=coef.device)
    pix_out = torch.empty_like(out) if want_pix else None
    with torch.cuda.device(coef.device):
        err = lib.jq_solve_rebalance(
            coef.data_ptr(), borders.data_ptr(), out.data_ptr(),
            _ptr(pix_out), div.data_ptr(), x1.data_ptr(), qshr.data_ptr(),
            *_kernel_tab(flags, True, coef.device), n, ld_coef, ld_borders,
            int(bool(do_rebalance)), int(bool(lanes)),
            torch.cuda.current_stream().cuda_stream)
    name = "solve_rebalance_lanes" if lanes else "solve_rebalance"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, pix_out


def solve_fused(coef, halo, image2, div, x1, qshr, flags, do_rebalance,
                want_pix=False):
    """One fused pass (B6) on given halos: the JOINT_YUV preamble when
    ``image2`` is given, else the LOW_QUALITY one (which needs
    ``flags & LOW_QUALITY``); the sweep runs unless ``flags &
    LOW_QUALITY``.  coef int32[64, n]; halo and image2 int32[100, n]
    (blocks_halo10, row-major, flattened); any of them may be a
    column-slice view of a whole plane.  Returns as solve_rebalance."""
    n = coef.shape[1]
    if image2 is None and not flags & LOW_QUALITY:
        raise ValueError("a fused pass needs image2 (JOINT_YUV) or "
                         "LOW_QUALITY flags")
    sweep = not flags & LOW_QUALITY
    tab = solver_tables(flags, coef.device) if sweep else None
    ts = [t for t in (coef, halo, image2, div, x1, qshr, tab)
          if t is not None]
    if _is_cpu(*ts):
        return planar.solve_fused(coef, halo, image2, div, x1, qshr, tab,
                                  flags, do_rebalance, want_pix)
    ld_coef = _row_stride(coef, 64, n, "coef")
    ld_halo = _row_stride(halo, 100, n, "halo")
    ld_image2 = (0 if image2 is None
                 else _row_stride(image2, 100, n, "image2"))
    _check_tables(div, x1, qshr)
    lib = _build.load()
    out = torch.empty((64, n), dtype=torch.int32, device=coef.device)
    pix_out = torch.empty_like(out) if want_pix else None
    with torch.cuda.device(coef.device):
        err = lib.jq_solve_fused(
            coef.data_ptr(), halo.data_ptr(), _ptr(image2), out.data_ptr(),
            _ptr(pix_out), div.data_ptr(), x1.data_ptr(), qshr.data_ptr(),
            *_kernel_tab(flags, sweep, coef.device), n, ld_coef, ld_halo,
            ld_image2, int(bool(do_rebalance)),
            torch.cuda.current_stream().cuda_stream)
    name = "solve_fused_joint" if image2 is not None else "solve_fused_lq"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, pix_out


# B7's preambles, as csrc/solver.cu numbers them
_PRE_JOINT, _PRE_LQ, _PRE_BORDERS = 0, 1, 2


def check_range(S, wb, b0, b1, edges):
    """Raise unless blocks [b0, b1) of an S-block grid of rows wb blocks
    wide read only blocks of the grid: a range that starts in the first
    row needs that row's top edge flagged, one that ends in the last row
    that row's bottom edge."""
    top_row, bot_row = edges
    if wb < 1 or S % wb or not 0 <= b0 <= b1 <= S:
        raise ValueError(f"bad range [{b0}, {b1}) of {S} blocks, wb={wb}")
    if b1 > b0 and ((b0 < wb and top_row != 0)
                    or (b1 > S - wb and bot_row != S // wb - 1)):
        raise ValueError(f"range [{b0}, {b1}) with edges {edges} reads "
                         f"beyond the {S // wb}-row grid")


def solve_range_pix(coef, pix, image2, div, x1, qshr, flags, do_rebalance,
                    wb, b0, b1, edges, coef_out, pix_out=None):
    """One resident pass over blocks [b0, b1) only (B7): B2 when
    ``image2`` is None and not ``flags & LOW_QUALITY``, else B3 (JOINT_YUV
    preamble, ``image2`` given) or B4 (LOW_QUALITY preamble); the sweep
    runs unless LOW_QUALITY.

    coef, pix int32[64, S] the whole planes of a grid with rows wb blocks
    wide (pix: the previous pass's pixels, from which each block's
    neighbourhood is read); image2 int32[100, S] or None; ``edges =
    (top_row, bot_row)``: the grid row whose top edge replicates and the
    one whose bottom edge does, -1 for none (the left and right edges are
    the grid's columns).  Writes blocks [b0, b1) of coef_out and, when
    given, of pix_out (the IDCT of the result), both int32[64, S] that
    alias no input; their other blocks are left as they were."""
    S = coef.shape[1]
    check_range(S, wb, b0, b1, edges)
    ins = {t.data_ptr() for t in (coef, pix, image2) if t is not None}
    outs = [t.data_ptr() for t in (coef_out, pix_out) if t is not None]
    if ins & set(outs) or len(set(outs)) < len(outs):
        raise ValueError("B7's outputs may alias no input or each other")
    if b1 == b0:
        return
    if image2 is None and flags & LOW_QUALITY:
        name, pre = "solve_range_pix_lq", _PRE_LQ
    elif image2 is None:
        name, pre = "solve_range_pix", _PRE_BORDERS
    else:
        name, pre = "solve_range_pix_joint", _PRE_JOINT
    sweep = not flags & LOW_QUALITY
    tab = solver_tables(flags, coef.device) if sweep else None
    ts = [t for t in (coef, pix, image2, div, x1, qshr, tab, coef_out,
                      pix_out) if t is not None]
    if _is_cpu(*ts):
        planar.solve_range_pix(coef, pix, image2, div, x1, qshr, tab, flags,
                               do_rebalance, wb, b0, b1, edges, coef_out,
                               pix_out)
        return
    for t, n in ((coef, "coef"), (pix, "pix"), (coef_out, "coef_out"),
                 (pix_out, "pix_out")):
        if t is not None:
            _check(t, torch.int32, (64, S), n)
    if image2 is not None:
        _check(image2, torch.int32, (100, S), "image2")
    _check_tables(div, x1, qshr)
    lib = _build.load()
    ktab, nt, pitch = _kernel_tab(flags, sweep, coef.device)
    with torch.cuda.device(coef.device):
        err = lib.jq_solve_range_pix(
            coef.data_ptr(), pix.data_ptr(), _ptr(image2), coef_out.data_ptr(),
            _ptr(pix_out), div.data_ptr(), x1.data_ptr(), qshr.data_ptr(),
            ktab, pre, nt, pitch, S, wb, b0, b1,
            edges[0], edges[1], int(bool(do_rebalance)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1


PEAK_CHAINS = (1, 4, 16)


def peak_chains_plain(x, nch, n_steps):
    """The plain version of T3: per element of x f32[n], ``nch`` chains
    a = a * 0.99999 + b (b = x * 0.9999, chain c starting at
    x * (1 + 0.001 c)), each product and sum its own rounded op, then a
    left fold of the chains -> f32[n]."""
    f32 = lambda v: torch.tensor(np.float32(v), dtype=torch.float32,
                                 device=x.device)
    start = torch.tensor([np.float32(1.0 + 0.001 * c) for c in range(nch)],
                         dtype=torch.float32, device=x.device)
    a = x[None, :] * start[:, None]
    b = x * f32(0.9999)
    k = f32(0.99999)
    for _ in range(n_steps):
        a = a * k
        a = a + b
    acc = a[0]
    for c in range(1, nch):
        acc = acc + a[c]
    return acc


def peak_chains(x, nch, n_steps):
    """T3, the fp32 peak probe: one thread per element of x f32[n] runs
    ``nch`` (1, 4 or 16) independent mul-then-add chains ``n_steps``
    deep, 2 * nch * n_steps fp32 operations per element."""
    if nch not in PEAK_CHAINS:
        raise ValueError(f"nch must be one of {PEAK_CHAINS}, got {nch}")
    if _is_cpu(x):
        return peak_chains_plain(x, nch, n_steps)
    _check(x, torch.float32, (x.numel(),), "x")
    lib = _build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.jq_peak(x.data_ptr(), out.data_ptr(), nch, n_steps,
                          x.numel(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "peak")
    LAUNCHES["peak"] += 1
    return out


def _canary_launch(name, out, *args):
    lib = _build.load()
    with torch.cuda.device(out.device):
        err = getattr(lib, name)(*args,
                                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    return out


def canary_muladd(a, b, c):
    """a*b + c on the card, built with the kernels' flags (CUDA only)."""
    out = torch.empty_like(a)
    return _canary_launch("jq_canary_muladd", out, a.data_ptr(),
                          b.data_ptr(), c.data_ptr(), out.data_ptr(),
                          a.numel())


def canary_fold(terms):
    """Left fold of terms f32[n, N] over n on the card (CUDA only)."""
    n, N = terms.shape
    out = torch.empty(N, dtype=torch.float32, device=terms.device)
    return _canary_launch("jq_canary_fold", out, terms.data_ptr(),
                          out.data_ptr(), n, N)


def canary_divide(a, b):
    """a / b on the card (CUDA only)."""
    out = torch.empty_like(a)
    return _canary_launch("jq_canary_divide", out, a.data_ptr(),
                          b.data_ptr(), out.data_ptr(), a.numel())
