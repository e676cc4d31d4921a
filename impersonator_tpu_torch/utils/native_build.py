"""Build and load the port's native code: the CUDA kernels of ``csrc/*.cu``
and the image codec of ``csrc/host_codec.cpp``.

A library is compiled at first use into ``impersonator_tpu_torch/_build/``
under a name tagged by a hash of its source and of the command that
builds it, so a changed source or flag builds anew and an unchanged one
is loaded as it is. The compiler writes a temporary file that is renamed
into place only when it succeeds; a failed build raises with the
compiler's output. :func:`bind` loads a library with ctypes and gives
each entry point of a ``{symbol: (restype, argtypes)}`` table its types.

:func:`kernel` serves the CUDA wrappers (``ops/cuda_raster.py``,
``ops/cuda_warp.py``): its first call compiles every ``csrc/*.cu`` not yet
built, one nvcc each, all started together, and each wrapper binds its
own source's entry points. The kernels' bits depend on ``NVCC_FLAGS``
(``--fmad=false`` keeps every multiply and add rounded on its own, as the
plain twins compute them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_KERNELS: dict = {}        # csrc/*.cu name -> its built library
_BOUND: dict = {}          # csrc/*.cu name -> its bound entry points
_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA toolkit's compiler: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build impersonator_tpu_torch's kernels")
    return str(path)


def build(jobs) -> tuple:
    """Build each ``(stem, source, command)`` whose library is missing,
    every compiler started at once; ``command`` is the compiler and its
    arguments, the source among them, and ``-o <file>`` is appended. A
    library is ``_build/<stem>_<tag>.so``, the tag a hash of the source's
    bytes and the command. Returns (the libraries' paths in job order,
    the compilers' output of this call). Raises with the output of every
    compiler that failed."""
    outs, running = [], []
    for stem, source, command in jobs:
        tag = hashlib.sha256(Path(source).read_bytes()
                             + " ".join(command).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{stem}_{tag}.so"
        outs.append(out)
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = tmp.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen([*command, "-o", str(tmp)],
                                        stdout=fh, stderr=subprocess.STDOUT)
            running.append((source, tmp, out, log, proc))
    logs, failed = [], []
    for source, tmp, out, log_path, proc in running:
        proc.wait()
        log = log_path.read_text()
        log_path.unlink()
        logs.append(log)
        if proc.returncode != 0:
            failed.append(f"building {source} failed:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs, "".join(logs)


def bind(path: Path, table: dict) -> SimpleNamespace:
    """Load the library at ``path`` and give each symbol of ``table``
    (``{symbol: (restype, argtypes)}``) its types."""
    so = ctypes.CDLL(str(path))
    lib = SimpleNamespace()
    for name, (restype, argtypes) in table.items():
        fn = getattr(so, name)
        fn.restype, fn.argtypes = restype, argtypes
        setattr(lib, name, fn)
    return lib


def build_kernels() -> str:
    """Compile every ``csrc/*.cu`` not yet built (one nvcc each, all
    started together); returns nvcc's output of this call's builds (''
    when every library was already built)."""
    sources = sorted(CSRC.glob("*.cu"))
    compiler = nvcc()
    paths, log = build([(src.stem, src, [compiler, *NVCC_FLAGS, str(src)])
                        for src in sources])
    _KERNELS.update((src.name, path) for src, path in zip(sources, paths))
    return log


def kernel(source: str, table: dict) -> SimpleNamespace:
    """``csrc/<source>``'s entry points of ``table``, bound; the first
    call builds every kernel source (:func:`build_kernels`)."""
    lib = _BOUND.get(source)
    if lib is None:
        with _LOCK:
            if not _KERNELS:
                build_kernels()
            lib = _BOUND[source] = bind(_KERNELS[source], table)
    return lib
