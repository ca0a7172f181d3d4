"""Run one cell of BENCHMARK.json once and print its result's line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is
one JSON object (correct, attempted, failed, metrics, device, and with
--trace 1 breakdown; then checks, each number compared beside its
limit); the same checks are the last lines of standard error.  Exits
with another code than 0, and prints no result, without a card, without
the program beside the benchmark, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout:
    only a checkout's first run builds."""
    build = os.path.join(ROOT, "build")
    os.environ["JPEGQS_TORCH_BUILD_DIR"] = os.path.join(build,
                                                        "jpegqs_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _cache_dirs()
    try:
        import jpegqs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"no result: the program jpegqs_tpu_torch is not beside the "
              f"benchmark ({e})", file=sys.stderr)
        sys.exit(2)
    from benchmark.harness import cell
    sys.exit(cell.main(sys.argv[1:], T_START))
