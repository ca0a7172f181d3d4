"""The benchmark of jpegqs_tpu_torch (see README.md)."""
