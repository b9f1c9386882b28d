"""Build and load the port's native code, at first use.

Two shared libraries with plain C entry points, loaded with ctypes (the
counterpart of brotli_tpu/native/__init__.py):

* ``libbrotli_tpu_torch_kernels.so`` -- the CUDA kernels (csrc/*.cu), built
  by ``nvcc`` for sm_90a.  Only a CUDA tensor's wrapper asks for it.
* ``libbrotli_tpu_torch_host.so`` -- csrc/host_shim.cpp, the same per-lane
  logic built by ``g++`` for the CPU.  Only the tests use it.

Each build is gated on a hash of its sources, headers and command, written
beside the library, so a checkout always runs code built from its own
sources.  Both land in ``brotli_tpu_torch/build/``, which git ignores.  A
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

# compiler output of the last build this process ran (nvcc's -Xptxas -v
# register and spill report); empty when the library was already built
last_build_log: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DECODE2_ARGS = [_P] * 12 + [_I] * 9
_RESOLVE_ARGS = [_P] * 5 + [_I, _I, ctypes.c_longlong]
_PACK_ARGS = [_P] * 12 + [_I] * 9


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built on this machine"
        )
    return str(path)


def _build(name: str, compiler: list[str], sources: list[Path]) -> Path:
    """Compile `sources` into BUILD_DIR/lib<name>.so unless a library built
    from the same sources, headers and command is already there."""
    out = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f".{name}.hash"
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in sorted(CSRC.glob("*.cuh")) + sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    digest = h.hexdigest()
    if out.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        last_build_log[name] = ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent test workers may
    # build at once, and a rename never exposes a half-written library
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [*compiler, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {out.name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    tmp_stamp = BUILD_DIR / f".{name}.{os.getpid()}.hash"
    tmp_stamp.write_text(digest)
    os.replace(tmp_stamp, stamp)
    last_build_log[name] = proc.stdout + proc.stderr
    return out


def _load(name: str, path: Path, entries: dict[str, list]) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in entries.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def kernels_lib() -> ctypes.CDLL:
    """The CUDA kernels (nvcc, sm_90a), built at first use."""
    name = "brotli_tpu_torch_kernels"
    if name not in _libs:
        srcs = [CSRC / "decode2.cu", CSRC / "resolve.cu", CSRC / "pack.cu"]
        path = _build(name, [_nvcc(), *NVCC_FLAGS], srcs)
        _load(name, path, {
            "brotli_torch_decode2": _DECODE2_ARGS + [_P],
            "brotli_torch_resolve": _RESOLVE_ARGS + [_P],
            "brotli_torch_pack": _PACK_ARGS + [_P],
        })
    return _libs[name]


def host_lib() -> ctypes.CDLL:
    """The kernels' per-lane logic built for the CPU (g++), for the tests."""
    name = "brotli_tpu_torch_host"
    if name not in _libs:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: cannot build the host shim")
        path = _build(name, [cxx, *HOST_FLAGS], [CSRC / "host_shim.cpp"])
        _load(name, path, {
            "brotli_torch_decode2_host": _DECODE2_ARGS,
            "brotli_torch_resolve_host": _RESOLVE_ARGS,
            "brotli_torch_pack_host": _PACK_ARGS,
        })
    return _libs[name]
