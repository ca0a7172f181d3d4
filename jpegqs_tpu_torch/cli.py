"""Command-line frontend of the PyTorch/CUDA port: the same options,
quality ladder, marker-copy policy and exit codes as ``jpegqs_tpu.cli``
(reference: quantsmooth.c:288-393 parser, 471-489 help text; exit 0
ok, 1 usage/IO error, 2 libjpeg warnings).  ``--backend`` picks the
device: ``cuda`` (the default) or ``cpu`` (the plain PyTorch
versions); ``--batch`` smooths many files through the bucketed batch
pipeline (batch.py) into an output directory.

    python -m jpegqs_tpu_torch.cli -q 3 -n 3 input.jpg output.jpg
    python -m jpegqs_tpu_torch.cli --batch -q 3 a.jpg b.jpg c.jpg outdir
"""

from __future__ import annotations

import os
import sys
import time

from .options import QsOptions, quality_to_flags, FLAGS_MASK

PROGNAME = "jpegqs-tpu-torch"
VERSION = "0.1.0"

HELP = f"""JPEG Quant Smooth (PyTorch/CUDA) : {VERSION}
Re-implementation of ilyakurdyukov/jpeg-quantsmooth on PyTorch + CUDA.

Usage:
  {PROGNAME} [options] input.jpg output.jpg

Options:
  -q, --quality n   Quality setting (1-6, default is 3)
  -n, --niter n     Number of iterations (default is 3)
  -t, --threads n   Accepted for compatibility (device runs all blocks)
  -o, --optimize    Option for libjpeg to produce smaller output file
  -v, --verbose n   Print libjpeg debug output
  -i, --info n      Print debug output (default is 15)
                      Use the sum of flags: 0 - silent,
                      1/2/4 - various information,
                      8 - processing time.
  -f, --flags n     Raw algorithm flag override (masked to 0x7F)
  -c, --copy n      Marker copy: 0 - none, 1 - comments, 2 - all (default)
      --backend s   Device: cuda (default) or cpu
      --trace dir   Write a torch.profiler trace of the smoothing phase
      --batch       Batch mode: inputs... outdir -- smooth many files
                    through the bucketed batch pipeline (batch.py)
"""


def parse_args(argv):
    """Reference-compatible hand-rolled parser (quantsmooth.c:288-378)."""
    opts = {
        "optimize": False, "verbose": 0, "info": 15, "copy": 2,
        "quality": 3, "niter": -1, "flags": -1, "threads": 0,
        "backend": None, "trace": None, "batch": False,
    }
    short = {"o": "--optimize", "v": "--verbose", "i": "--info",
             "n": "--niter", "q": "--quality", "t": "--threads",
             "f": "--flags", "p": "--cpu", "c": "--copy"}
    args = list(argv)
    pos = []
    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("-") or arg == "-":
            pos.append(arg)
            i += 1
            continue
        if arg == "--":
            pos.extend(args[i + 1:])
            break
        name, val = arg, None
        if not arg.startswith("--"):
            c = arg[1]
            if c not in short:
                raise SystemExit(f"{PROGNAME}: unknown option {arg}")
            name = short[c]
            if len(arg) > 2:
                val = arg[2:]
        if "=" in name:
            name, val = name.split("=", 1)
        key = name[2:]
        if key in ("optimize", "batch"):
            opts[key] = True
            i += 1
            continue
        if key == "cpu":  # accepted, no effect on the device
            key = "threads"
        if key not in opts:
            raise SystemExit(f"{PROGNAME}: unknown option {name}")
        if val is None:
            if i + 1 >= len(args):
                raise SystemExit(f"{PROGNAME}: missing value for {name}")
            val = args[i + 1]
            i += 2
        else:
            i += 1
        if key in ("backend", "trace"):
            opts[key] = val
        else:
            if not val.isdigit() and not (val.startswith("-")
                                          and val[1:].isdigit()):
                raise SystemExit(f"{PROGNAME}: bad value for {name}")
            opts[key] = int(val)
    return opts, pos


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        opts, pos = parse_args(argv)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    if (len(pos) < 2) if opts["batch"] else (len(pos) != 2):
        sys.stderr.write(HELP)
        return 1
    backend = opts["backend"] or "cuda"
    if backend not in ("cuda", "cpu"):
        print(f"{PROGNAME}: unknown backend {backend} (cuda, cpu)",
              file=sys.stderr)
        return 1

    # quality ladder -> flags (quantsmooth.c:380-393)
    flags = quality_to_flags(opts["quality"])
    if opts["flags"] >= 0:
        flags = opts["flags"] & FLAGS_MASK
    niter = opts["niter"] if opts["niter"] >= 0 else 3
    info = opts["info"]
    qs_opts = QsOptions(flags=flags, niter=niter, threads=opts["threads"])
    if opts["batch"]:
        return _main_batch(pos[:-1], pos[-1], opts, qs_opts, backend)

    from .host.jpegio import JpegCoefFile
    from . import engine

    infile, outfile = pos
    try:
        if infile == "-":
            data = sys.stdin.buffer.read()
        else:
            with open(infile, "rb") as f:
                data = f.read()
    except OSError:
        print(f'{PROGNAME}: can\'t open input file "{infile}"',
              file=sys.stderr)
        return 1

    num_warnings = 0
    try:
        with JpegCoefFile(data, copy_markers=opts["copy"],
                          verbose=opts["verbose"]) as f:
            img = f.read()
            if info & 1:
                print(f"width/height: {img.width}x{img.height}, "
                      f"components: {img.num_components}", file=sys.stderr)
                for ci, c in enumerate(img.components):
                    print(f"  comp {ci}: sampling {c.h_samp_factor}x"
                          f"{c.v_samp_factor}, blocks {c.width_in_blocks}x"
                          f"{c.height_in_blocks}", file=sys.stderr)
            if info & 2:
                for ci, c in enumerate(img.components):
                    print(f"quant table {c.quant_tbl_no} (comp {ci}):",
                          file=sys.stderr)
                    for row in c.quantval.reshape(8, 8):
                        print("  " + " ".join(f"{v:3d}" for v in row),
                              file=sys.stderr)
            if info & 4:
                # INFO_COMP2: per-component block dims
                # (reference: quantsmooth.h:2569-2572)
                for ci, c in enumerate(img.components):
                    print(f"component[{ci}] : size {c.width_in_blocks}x"
                          f"{c.height_in_blocks}", file=sys.stderr)
            if info & 16:
                solver = ("cuda kernels" if backend == "cuda"
                          else "plain torch")
                print(f"backend: {backend}, solver: {solver}",
                      file=sys.stderr)
            if info & 8 and not os.environ.get("JPEGQS_NO_WARMUP"):
                # the reference's timed region is pure smoothing
                # (quantsmooth.h:2820-2825); build the kernels and warm
                # the allocator with an untimed run first
                engine.smooth(img, qs_opts, backend)
            t0 = time.monotonic()
            if opts["trace"]:
                res = _traced_smooth(engine, img, qs_opts, backend,
                                     opts["trace"])
            else:
                res = engine.smooth(img, qs_opts, backend)
            elapsed = (time.monotonic() - t0) * 1000
            if info & 8:
                print(f"time: {elapsed:.3f} ms", file=sys.stderr)
            for ci in range(len(img.components)):
                f.write_coefs(ci, res.coefs[ci])
            if res.upsampled is not None:
                f.set_upsampled(res.upsampled[0], res.upsampled[1])
            out = f.save(optimize=bool(opts["optimize"]))
            num_warnings = f.num_warnings()
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"{PROGNAME}: {e}", file=sys.stderr)
        return 1

    try:
        if outfile == "-":
            sys.stdout.buffer.write(out)
        else:
            with open(outfile, "wb") as f:
                f.write(out)
    except OSError:
        print(f'{PROGNAME}: can\'t open output file "{outfile}"',
              file=sys.stderr)
        return 1
    # libjpeg warned (damaged input etc.) -> exit 2, like the reference
    # (quantsmooth.c:626: jsrcerr.num_warnings + jdsterr.num_warnings)
    return 2 if num_warnings else 0


def _main_batch(infiles, outdir, opts, qs_opts, backend) -> int:
    """--batch: smooth many files through the bucketed corpus pipeline
    (batch.smooth_corpus) into an output directory, each output under its
    input's basename."""
    from .batch import smooth_corpus

    names = [os.path.basename(p) for p in infiles]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        print(f"{PROGNAME}: duplicate output names in batch: "
              f"{sorted(dup)[0]} (outputs are written to outdir by "
              f"basename)", file=sys.stderr)
        return 1
    datas = []
    for p in infiles:
        try:
            with open(p, "rb") as f:
                datas.append(f.read())
        except OSError:
            print(f'{PROGNAME}: can\'t open input file "{p}"',
                  file=sys.stderr)
            return 1
    try:
        os.makedirs(outdir, exist_ok=True)
    except OSError:
        print(f'{PROGNAME}: can\'t create output directory "{outdir}"',
              file=sys.stderr)
        return 1
    t0 = time.monotonic()
    warnings_out = []
    try:
        outs = smooth_corpus(datas, qs_opts,
                             optimize=bool(opts["optimize"]),
                             copy_markers=opts["copy"],
                             warnings_out=warnings_out, device=backend)
    except (ValueError, RuntimeError) as e:
        print(f"{PROGNAME}: {e}", file=sys.stderr)
        return 1
    elapsed = (time.monotonic() - t0) * 1000
    for name, out in zip(names, outs):
        dest = os.path.join(outdir, name)
        try:
            with open(dest, "wb") as f:
                f.write(out)
        except OSError:
            print(f'{PROGNAME}: can\'t open output file "{dest}"',
                  file=sys.stderr)
            return 1
    if opts["info"] & 8:
        print(f"time: {elapsed:.3f} ms ({len(outs)} files)",
              file=sys.stderr)
    # exit 2 when any file produced libjpeg warnings (quantsmooth.c:626)
    return 2 if (warnings_out and warnings_out[0]) else 0


def _traced_smooth(engine, img, qs_opts, backend, trace_dir):
    """engine.smooth under torch.profiler (utils.profiling.device_trace);
    the Chrome trace goes to trace_dir/smooth_trace.json."""
    from .utils.profiling import device_trace

    with device_trace(trace_dir, backend, "smooth_trace.json"):
        res = engine.smooth(img, qs_opts, backend)
    return res


if __name__ == "__main__":
    sys.exit(main())
