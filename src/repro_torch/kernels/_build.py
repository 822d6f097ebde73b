"""Build of the port's CUDA sources at first use.

Each library is compiled by ``nvcc`` straight from the sources in the
package into a shared library with a plain C interface (loaded with
``ctypes``; no PyTorch headers, so a build takes seconds). The library is
named by a hash of its sources and flags and kept under
``repro_torch/_build/``, so a changed source builds anew and an unchanged
one is built once per checkout.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# Hopper only (wgmma/setmaxnreg need the "a" target). -fmad=false keeps
# a*b+c as two rounded operations, as the plain PyTorch versions compute
# it; no fast math, so division, sqrt and exp stay IEEE / libdevice.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
# The attention kernels are held to a tolerance, not bitwise: they keep
# nvcc's fused multiply-adds.
ATTENTION_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")


def nvcc_path() -> str:
    """The ``nvcc`` to call: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_command(sources, output, nvcc: str = "nvcc",
                  flags=NVCC_FLAGS) -> list[str]:
    """The ``nvcc`` command line that builds ``sources`` into ``output``."""
    return [nvcc, *flags, "-o", str(output), *map(str, sources)]


def source_hash(sources, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return h.hexdigest()[:16]


def build(name: str, sources, flags=NVCC_FLAGS) -> Path:
    """Return the path of the built library, compiling it if needed with
    ``flags`` (``NVCC_FLAGS`` unless a library asks for its own).

    The compiler's report (registers, shared memory, spills) is written
    beside it as ``<library>.log``. Raises ``RuntimeError`` with the
    compiler's output when the build fails.
    """
    sources = [Path(s) for s in sources]
    out = BUILD_DIR / f"{name}-{source_hash(sources, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = build_command(sources, tmp, nvcc_path(), flags)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}: {' '.join(cmd)}\n{proc.stdout}"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)     # atomic: a concurrent build sees all or none
    return out


def ptxas_usage(log_path, kernel: str) -> dict:
    """Registers and spill bytes of each instantiation of ``kernel`` from a
    build's ``.log`` (ptxas -v): {mangled entry: {"registers", "spill_stores",
    "spill_loads"}}."""
    usage, entry = {}, None
    for line in Path(log_path).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
            if entry:
                usage[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[entry].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m.group(1))
    return usage
