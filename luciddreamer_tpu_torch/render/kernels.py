"""Build and load the port's hand-written CUDA kernels.

Every kernel lives in ``csrc/<name>.cu`` with a plain C interface: one
launch function ``<name>(...)`` that enqueues the kernel's passes on the
stream it is given and returns ``cudaGetLastError()``, and
``kernel_error_string``; device code that several kernels share lives in
``csrc/*.cuh`` headers.  At first use the source is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the root of the checkout, keyed
by a hash of the source, the headers and the flags; ptxas's register, spill
and shared-memory report is kept beside the library as ``.log``.  The library is loaded with ``ctypes``.
A failed build or a launch that returns an error raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in sources) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(*names: str) -> None:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        so = library_path(name)
        so.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))


def _load(name: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), its
    launch function typed with ``argtypes`` and returning an int."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, argtypes: list, *args) -> None:
    """Call kernel ``name``'s launch function; raise on a launch error."""
    lib = _load(name, argtypes)
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.kernel_error_string(err).decode()}"
        )


def build_log(name: str) -> str:
    """The compiler's output of the current build of ``name``, or ''."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
