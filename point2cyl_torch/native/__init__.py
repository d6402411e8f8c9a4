"""Host-side native (C++) components, bound with ctypes.

At first use a source ``<name>.cpp`` of this directory is compiled with
``g++ -O3 -march=native -shared -fPIC -std=c++17`` into
``point2cyl_torch/build/lib<name>_<hash>.so``, named by a hash of the
source and the flags, so an edited source never loads a stale build. A
failed build raises with the compiler's output: nothing falls back to a
slower path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    src = _DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / out.name
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(_DIR / f"{name}.cpp"), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build native/{name}.cpp:\n{proc.stdout}")
        os.replace(tmp_lib, out)


def load(name: str) -> ctypes.CDLL:
    """The library built from ``native/<name>.cpp``, built on first call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _build(name, path)
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
