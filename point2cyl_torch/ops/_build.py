"""Build and load the port's CUDA kernels.

At first use, every ``point2cyl_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process (all started together) for ``sm_90a`` and the objects are
linked into one shared library in ``point2cyl_torch/build/``, named by a
hash of the sources, the headers (``csrc/*.cuh``) and the flags, so an
edited source or header never loads a stale build. The library has a plain C interface and is loaded with ``ctypes``:
each entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch.

Nothing here runs when the package is imported, and only CUDA tensors
reach it: the wrappers route CPU tensors to the plain versions. The build
or load runs in a ``p2c.build`` span (``core/profiling.py``), which shows
it in a traced set-up.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from point2cyl_torch.core.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built"
    )


def _sources() -> list[Path]:
    """The sources nvcc compiles, a process each."""
    return sorted(CSRC.glob("*.cu"))


def _hashed() -> list[Path]:
    """Every file a build reads from ``csrc``: the sources and the headers
    they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _library_path(inputs: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in inputs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libp2c_kernels_{h.hexdigest()[:16]}.so"


def _build(sources: list[Path], out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failures = []
        for src, proc in zip(sources, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
        if failures:
            raise RuntimeError("nvcc failed\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed\n{link.stdout}")
        os.replace(tmp_lib, out)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    if _lib is None:
        with span("build"):
            path = _library_path(_hashed())
            if not path.exists():
                _build(_sources(), path)
            _lib = ctypes.CDLL(str(path))
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """Entry point ``name`` of the library, with its C signature set."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        describe = library().p2c_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name}: CUDA error {status}: {describe(status).decode()}"
        )
