"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout. The file name carries a
hash of the source, of every header it includes with quotes (recursively),
and of the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them together.

Every C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream, and returns ``cudaGetLastError()``;
``check`` turns a non-zero code into an exception. Nothing here runs on
import: the CPU tests import every module and have no ``nvcc``.

There is no ``--use_fast_math``: its approximate division would move DAC
codes that sit on a rounding tie.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("cam_match", "crossbar_mvm", "csr_aggregate", "fused_layer",
           "rglru_scan", "wkv6_scan", "flash_attention", "adamw")
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin``, else under
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin; the CUDA kernels cannot be built")


def source_files(path: Path) -> list:
    """``path`` and every header it includes with quotes, recursively,
    each resolved against the directory of the file that includes it."""
    files, todo = [], [path.resolve()]
    while todo:
        f = todo.pop()
        if f in files:
            continue
        files.append(f)
        for inc in _QUOTED_INCLUDE.findall(f.read_text()):
            todo.append((f.parent / inc).resolve())
    return files


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source, headers and flags."""
    h = hashlib.sha256()
    for f in source_files(CSRC / f"{name}.cu"):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` each, all started together. Returns ``{name: compiler log}``
    for the sources built now (the ``-Xptxas=-v`` register and shared
    memory report). Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def c_function(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its argument types declared and
    an ``int`` (the CUDA error code) as its result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
