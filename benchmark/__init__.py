"""The benchmark of jasper_tpu_torch (see README.md)."""
