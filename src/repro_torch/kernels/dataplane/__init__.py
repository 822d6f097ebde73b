"""Data-plane kernels: CUDA sources (csrc/), ctypes binding (kernel),
wrappers with launch counters (ops) and plain versions (ref)."""
