"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `ltx_tpu_torch/csrc/` is compiled on first use into a
shared library with a plain C interface, for `sm_90a` (Hopper), into
`build/ltx_tpu_torch/` at the repository root. The library's file name
carries a digest of the source, the headers of `csrc/` it includes and the
flags, so an edited source or header builds anew. Nothing here runs at
import time: the CPU tests import the kernel modules on machines without
nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ltx_tpu_torch"

# every kernel source of the port, by stem
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "int4_matmul", "rms_norm",
           "rope_tables")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBRARIES: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen=None) -> list:
    """`path` and every header of `CSRC_DIR` it includes with quotes,
    transitively, each once, in the order first met."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = CSRC_DIR / name.decode()
            if header.is_file():
                _sources(header, seen)
    return seen


def library_path(name: str) -> Path:
    """The library of source `name`: its file name carries a digest of the
    source, the headers it includes from `CSRC_DIR` and the flags."""
    digest = hashlib.sha256()
    for path in _sources(CSRC_DIR / f"{name}.cu"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one nvcc
    per source, all started together. Returns the seconds each build took
    (0.0 when it was already built); raises with nvcc's log on a failure,
    after every started nvcc has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    started = {}
    t0 = time.perf_counter()
    for name in seconds:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    failures = []
    for name, (proc, tmp, out) in started.items():
        log = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"kernel build of {name} failed "
                            f"(nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBRARIES[name] = lib
    return lib
