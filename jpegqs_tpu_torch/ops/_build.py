"""Build and load the CUDA kernels of ``csrc/solver.cu``.

nvcc compiles the source into a shared library with a plain C
interface on first use (a few seconds), under ``build/jpegqs_tpu_torch/``
beside the package (override with ``JPEGQS_TORCH_BUILD_DIR``); the
file name carries a hash of the source and the flags, so an edited
source rebuilds.  The library is loaded with ctypes and every entry
point gets explicit ``argtypes``: pointers and the stream as
``c_void_p`` (a bare Python int would be cut to 32 bits).

Nothing here runs at import time: this module is imported on machines
without nvcc or a card, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "solver.cu")

# -fmad=false: no mul+add contraction; -prec-div=true: IEEE division;
# -ftz=false: keep fp32 subnormals.  Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-ftz=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "jq_idct_pix": [_P, _P, _I, _P],
    "jq_solve_rebalance_pix": [_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P],
    "jq_solve_fused_pix": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
    "jq_solve_rebalance": [_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    "jq_solve_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    "jq_solve_range_pix": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "jq_peak": [_P, _P, _I, _I, _I, _P],
    "jq_canary_muladd": [_P, _P, _P, _P, _I, _P],
    "jq_canary_fold": [_P, _P, _I, _I, _P],
    "jq_canary_divide": [_P, _P, _P, _I, _P],
}

_lib = None


def build_dir() -> str:
    return os.environ.get("JPEGQS_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "jpegqs_tpu_torch")


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, the default toolkit path, or PATH."""
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"libjqsolver_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile solver.cu unless the library for this source exists.
    nvcc's report (ptxas registers, stack, spills) is kept beside the
    library as ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
    os.close(fd)
    r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    with open(path + ".log", "w") as f:
        f.write(r.stderr)
    os.replace(tmp, path)          # atomic: concurrent builders agree
    return path


def ptxas_report(log_text: str) -> list:
    """nvcc's ``-Xptxas -v`` report per kernel instantiation, in the order
    compiled: dicts with ``name`` (``kernel<args>``, demangled far enough
    to tell the instantiations apart; int and bool arguments as numbers),
    ``registers``, ``spill_stores``, ``spill_loads`` (bytes) and ``smem``
    (static shared memory, bytes)."""
    rows = []
    for entry in log_text.split("Compiling entry function '")[1:]:
        mangled = entry.split("'")[0]
        name, pos = mangled, mangled.find("N") + 1
        while (m := re.match(r"\d+", mangled[pos:])):  # <length><ident>
            pos += m.end()
            ident = mangled[pos:pos + int(m.group())]
            pos += len(ident)
            if ident.endswith("_kernel"):
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
                name = ident + ("<" + ",".join(re.findall(
                    r"L[ib](\d+)E", args.group(1))) + ">" if args else "")
                break
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        rows.append({"name": name,
                     "registers": int(regs.group(1)) if regs else -1,
                     "spill_stores": int(spill.group(1)) if spill else -1,
                     "spill_loads": int(spill.group(2)) if spill else -1,
                     "smem": int(smem.group(1)) if smem else 0})
    return rows


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
