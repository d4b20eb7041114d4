"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/kernels/<name>-<hash>.so`` under the repository root,
loaded with ``ctypes``. The hash covers the source, every shared header
and the compiler flags, so an edited source or header is rebuilt and an
unchanged one is reused. Nothing is built at import time: the first
``load`` builds every missing library at once, one ``nvcc`` process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("kv_write", "block_copy", "paged_attention", "paged_prefill",
           "block_quant", "ssd_scan", "swa_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on first use and need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name hashes the source, every
    ``csrc/*.cuh`` header (any source may include any of them) and the
    compiler flags."""
    h = hashlib.sha256()
    for part in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every library that is not built yet, all in parallel,
    keeping nvcc's output beside each library. Returns
    ``{name: nvcc output}`` for the ones compiled now; raises with nvcc's
    output if any compile fails."""
    todo = [n for n in SOURCES if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            lib_path(n).with_suffix(".log").write_text(out)
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def ptxas_report(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` register, shared-memory and
    spill report) from the build of ``csrc/<name>.cu``."""
    return lib_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all missing
    libraries first."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
