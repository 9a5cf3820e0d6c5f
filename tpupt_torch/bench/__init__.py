"""Benchmark harness and scaling measurement (counterpart of ``tpupt/bench/``)."""
