"""Build the CUDA C++ sources in ``repro_torch/csrc`` and load them.

Each source compiles with nvcc into its own shared library with a plain C
interface, bound with `ctypes` (no PyTorch headers, so a build takes
seconds). Libraries land in ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a digest of the source and the flags,
so an edited source never loads a stale library. Nothing builds at import
time: the first launch builds what it needs, and `build_all` builds several
sources at once (one nvcc process each, started together); `build_copies`
builds edited copies of them the same way (the tools' tile sweeps and
probed kernels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# IEEE division and no multiply-add contraction: the kernels must round
# exactly as the reference does (no --use_fast_math, --fmad=false).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler that PyTorch's own extension builder finds."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed")
    path = Path(CUDA_HOME) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}")
    return str(path)


def library_path(source: str) -> Path:
    """Where ``source``'s library goes: digest of its text and the flags."""
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str):
    out = library_path(source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return out, tmp, proc


def build_all(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every source not built yet, all nvcc processes at once.

    Returns {source: compiler log} for the sources built now (the log holds
    ptxas' register and shared-memory report). Raises on a failed build.
    """
    started = []
    for src in sources:
        if not library_path(src).exists():
            started.append((src, *_start(src)))
    logs, errors = {}, []
    for src, out, tmp, proc in started:
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed.

    ``bind`` declares the C functions' argtypes/restype once per process.
    """
    lib = _LIBS.get(source)
    if lib is None:
        build_all([source])
        lib = ctypes.CDLL(str(library_path(source)))
        bind(lib)
        _LIBS[source] = lib
    return lib


def build_copies(texts: Dict[str, str], subdir: str) -> Dict[str, Tuple[Path, str]]:
    """Compile edited copies of kernel sources (a tile sweep's variants, a
    probed kernel), every nvcc process at once with the port's flags, into
    ``build/repro_torch/<subdir>/<name>.so``.

    Returns {name: (library path, compiler log)}. Raises on a failed build.
    """
    out_dir = BUILD_DIR / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        built[name] = (lib, log)
    return built


def ptxas_report(log: str, entry: str) -> dict:
    """Registers and spill bytes that ptxas reports in ``log`` for the
    kernel instance whose mangled name contains ``entry``."""
    out, current = {}, False
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            current = entry in m.group(1)
        elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out["spill_stores"], out["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif current and (m := re.search(r"Used (\d+) registers", ln)):
            out["registers"] = int(m.group(1))
    return out
