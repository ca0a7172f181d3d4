"""The plain reference of the benchmark's `correct` check.

A frozen copy of the plain path of the program's smoothing engine (the
eager PyTorch versions of its kernels and of its colour glue), run one
image at a time in plain torch operations on whatever device the caller
names.  It imports nothing of the program: its tables (the solver's
per-coefficient weights, the quantization "magic" tables) are worked out
again here from the published algorithm, and its inputs are the
harness's own arrays.

``float_dtype`` selects the precision of every floating-point operation:
float32 is the reference; bfloat16 is the control, the nearest precision
below it, which has to come out as not correct.
"""
