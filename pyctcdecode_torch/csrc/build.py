"""Build and load the hand-written CUDA kernels (nvcc + ctypes) and the native ARPA loader (g++).

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

and the host-only n-gram engine ``csrc/ctclm.cpp`` (:mod:`.native`) with::

    g++ -O3 -march=native -std=c++17 -shared -fPIC -o build/libctclm-<hash>.so csrc/ctclm.cpp

The library lands in ``build/`` at the repository root at first use (the
file name carries a hash of the source, so an edited source rebuilds) and is
loaded with :mod:`ctypes`. A compiler writes to a temporary file that is
renamed into place, so processes that build at once (test workers) never
load a half-written library. Sources build in parallel, one compiler each.
No fast-math flag: the kernels' ``expf``/``logf`` must track PyTorch's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parents[1] / "build"
SOURCES = ("merge.cu", "gather.cu", "backtrace.cu", "replay.cu", "walk.cu")  # the CUDA kernels
NATIVE_SOURCE = "ctclm.cpp"  # the host n-gram engine
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
            "kernels of pyctcdecode_torch need the CUDA toolkit"
        )
    return path


def library_path(source: str) -> Path:
    """Where ``source``'s shared library lives (hash of the source text)."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(sources: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing; all compilers run at once.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and prints the compiler's output. Returns source -> library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    pending: List[tuple] = []
    for src in sources:
        lib = library_path(src)
        out[src] = lib
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        if src.endswith(".cu"):
            cmd = [
                _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-o", tmp, str(CSRC_DIR / src),
            ]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
        else:
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
                   str(CSRC_DIR / src)]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
        except OSError as err:  # no compiler on PATH
            os.unlink(tmp)
            raise RuntimeError(f"{src}: cannot run {cmd[0]}: {err}") from err
        pending.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in pending:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {src}]\n{log}", flush=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one source's library (callers cache it)."""
    lib = build([source])[source]
    return ctypes.CDLL(str(lib))
