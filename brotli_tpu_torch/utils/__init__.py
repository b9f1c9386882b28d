"""Benchmark and profiling helpers for the card: a CUDA-event timer
(benchmarks.py) and a torch.profiler trace with per-phase reports of the
decode round trip and the device encode (profiling.py)."""
