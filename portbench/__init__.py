"""Benchmark of dbeel_tpu_torch on one NVIDIA card; the entry is run.py."""
