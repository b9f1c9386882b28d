"""Build and load the port's native code, at first use.

Two shared libraries with plain C entry points, loaded with ctypes (the
counterpart of brotli_tpu/native/__init__.py):

* ``libbrotli_tpu_torch_kernels.so`` -- the CUDA kernels (csrc/*.cu), built
  by ``nvcc`` for sm_90a: one nvcc process per source, all started
  together, then one link.  Only a CUDA tensor's wrapper asks for it.
* ``libbrotli_tpu_torch_host.so`` -- csrc/host_shim.cpp, the same per-lane
  logic built by ``g++`` for the CPU.  Only the tests use it.

native/__init__.py builds the host codec's C++ library through `_build`
too.

The parallel nvcc build of the first four sources took 3.5 s on the
H100's host where one nvcc command over them took 9.6 s.  A source may
carry flags of its own (SOURCE_FLAGS).

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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]
KERNEL_SOURCES = ["decode2.cu", "decode3.cu", "resolve.cu", "pack.cu",
                  "parse.cu", "probe.cu", "zopfli.cu", "matches.cu",
                  "records.cu", "device_decode.cu"]
# flags of one source only: the Zopfli DP's float64 costs are sums in the
# host's order, and no multiply-add may contract one
SOURCE_FLAGS = {"zopfli.cu": ["-fmad=false"]}
HOST_FLAGS = ["-std=c++17", "-O2", "-fPIC"]
HOST_LINK_FLAGS = ["-shared"]

# compiler output of the last build this process ran (nvcc's -Xptxas -v
# register and spill report); empty when the library was already built
last_build_log: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_DECODE2_DIRECT_ARGS = [_P] * 12 + [_I] * 9
_DECODE2_ARGS = _DECODE2_DIRECT_ARGS + [_I]           # + lanes a warp
_DECODE3_DIRECT_ARGS = [_P] * 17 + [_I] * 10         # ... group lanes
_DECODE3_ARGS = _DECODE3_DIRECT_ARGS + [_I] * 3       # + lanes a warp,
                                                      # window, table budget
_RESOLVE_DIRECT_ARGS = [_P] * 5 + [_I, _I, ctypes.c_longlong]
_RESOLVE_ARGS = _RESOLVE_DIRECT_ARGS + [_I]           # + window bytes
_PACK_ARGS = [_P] * 13 + [_I] * 9
_PACK_SERIAL_ARGS = [_P] * 12 + [_I] * 9
_PARSE_ARGS = [_P] * 6 + [_I] * 6
_MATCHES_ARGS = [_P] * 4 + [_I] * 6
_RECORDS_ARGS = [_P] * 11 + [_I] * 4
_ZOPFLI_DIRECT_ARGS = [_P] * 19 + [_I] * 5
_ZOPFLI_ARGS = [_P] * 20 + [_I] * 6                   # + records; blocks,
                                                      # window
_DEVICE_DECODE_ARGS = [_P] * 7 + [_I] * 3
_PROBE_V2_ARGS = [_P] * 3 + [_I] * 3
_PROBE_V2B_ARGS = [_P] * 4 + [_I] * 8


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


def _build(name: str, compiler: list[str], link: list[str],
           sources: list[Path], deps: list[Path] = ()) -> Path:
    """Compile `sources` into BUILD_DIR/lib<name>.so unless a library built
    from the same sources, headers (csrc/*.cuh and `deps`) and commands is
    already there.  Each source compiles to an object in its own process,
    all started together, and `link` joins the objects."""
    out = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f".{name}.hash"
    h = hashlib.sha256(" ".join(compiler + link).encode())
    for src in sorted(CSRC.glob("*.cuh")) + list(deps) + sources:
        h.update(src.name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(src.name, [])).encode())
        h.update(src.read_bytes())
    digest = h.hexdigest()
    if out.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        last_build_log[name] = ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under private names and rename: concurrent test workers may
    # build at once, and a rename never exposes a half-written library
    pid = os.getpid()
    tmp = BUILD_DIR / f".lib{name}.{pid}.so"
    objs = [BUILD_DIR / f".{name}.{src.stem}.{pid}.o" for src in sources]
    cmds = [[*compiler, *SOURCE_FLAGS.get(src.name, []), "-c", "-o", str(o),
             str(src)] for o, src in zip(objs, sources)]
    cmds.append([*link, "-o", str(tmp), *map(str, objs)])
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        logs = [p.communicate()[0] for p in procs]
        procs.append(subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
        logs.append(procs[-1].stdout)
        for c, p, text in zip(cmds, procs, logs):
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {out.name} failed "
                                   f"({' '.join(c)}):\n{text}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    tmp_stamp = BUILD_DIR / f".{name}.{pid}.hash"
    tmp_stamp.write_text(digest)
    os.replace(tmp_stamp, stamp)
    last_build_log[name] = "".join(logs)
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
        nvcc = _nvcc()
        path = _build(name, [nvcc, *NVCC_FLAGS], [nvcc, *NVCC_LINK_FLAGS],
                      [CSRC / src for src in KERNEL_SOURCES])
        _load(name, path, {
            "brotli_torch_decode2": _DECODE2_ARGS + [_P],
            "brotli_torch_decode2_direct": _DECODE2_DIRECT_ARGS + [_P],
            "brotli_torch_decode3": _DECODE3_ARGS + [_P],
            "brotli_torch_decode3_direct": _DECODE3_DIRECT_ARGS + [_P],
            "brotli_torch_resolve": _RESOLVE_ARGS + [_P],
            "brotli_torch_resolve_direct": _RESOLVE_DIRECT_ARGS + [_P],
            "brotli_torch_pack": _PACK_ARGS + [_P],
            "brotli_torch_pack_serial": _PACK_SERIAL_ARGS + [_P],
            "brotli_torch_parse": _PARSE_ARGS + [_P],
            "brotli_torch_parse_direct": _PARSE_ARGS + [_P],
            "brotli_torch_parse_config": [_P],
            "brotli_torch_matches": _MATCHES_ARGS + [_P],
            "brotli_torch_matches_config": [_I, _P],
            "brotli_torch_matches_direct": _MATCHES_ARGS + [_P],
            "brotli_torch_matches_direct_config": [_I, _P],
            "brotli_torch_records_direct": _RECORDS_ARGS + [_I, _P],  # + SMs
            "brotli_torch_records": _RECORDS_ARGS + [_I, _P],  # + SMs
            "brotli_torch_records_config": [_I, _P],
            "brotli_torch_zopfli": _ZOPFLI_ARGS + [_P],
            "brotli_torch_zopfli_direct": _ZOPFLI_DIRECT_ARGS + [_P],
            "brotli_torch_device_decode": _DEVICE_DECODE_ARGS + [_I, _P],
            "brotli_torch_device_decode_direct": _DEVICE_DECODE_ARGS
            + [_I, _P],
            "brotli_torch_device_decode_config": [_P],
            "brotli_torch_probe_v2": _PROBE_V2_ARGS + [_P],
            "brotli_torch_probe_v2b": _PROBE_V2B_ARGS + [_P],
        })
    return _libs[name]


def host_lib() -> ctypes.CDLL:
    """The kernels' per-lane logic built for the CPU (g++), for the tests."""
    name = "brotli_tpu_torch_host"
    if name not in _libs:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: cannot build the host shim")
        path = _build(name, [cxx, *HOST_FLAGS], [cxx, *HOST_LINK_FLAGS],
                      [CSRC / "host_shim.cpp"])
        _load(name, path, {
            "brotli_torch_decode2_host": _DECODE2_ARGS,
            "brotli_torch_decode2_direct_host": _DECODE2_DIRECT_ARGS,
            "brotli_torch_decode3_host": _DECODE3_ARGS,
            "brotli_torch_decode3_direct_host": _DECODE3_DIRECT_ARGS,
            "brotli_torch_resolve_host": _RESOLVE_ARGS,
            "brotli_torch_resolve_direct_host": _RESOLVE_DIRECT_ARGS,
            "brotli_torch_pack_host": _PACK_ARGS,
            "brotli_torch_pack_serial_host": _PACK_SERIAL_ARGS,
            "brotli_torch_parse_host": _PARSE_ARGS + [_I, _I],  # + tile, seg
            "brotli_torch_parse_direct_host": _PARSE_ARGS,
            "brotli_torch_parse_ring_host": [_P, _I, _P, _I, _I, _I],
            "brotli_torch_matches_host": _MATCHES_ARGS + [_I],  # + seg
            "brotli_torch_records_host": _RECORDS_ARGS + [_I],  # + segments
            "brotli_torch_zopfli_host": _ZOPFLI_ARGS,
            "brotli_torch_zopfli_direct_host": _ZOPFLI_DIRECT_ARGS,
            "brotli_torch_zopfli_min_len_host": [_P, _I, _I,
                                                 ctypes.c_double],
            # + words ring, window bytes
            "brotli_torch_device_decode_host": _DEVICE_DECODE_ARGS + [_I, _I],
            "brotli_torch_device_decode_direct_host": _DEVICE_DECODE_ARGS,
            "brotli_torch_probe_v2_host": _PROBE_V2_ARGS,
            "brotli_torch_probe_v2b_host": _PROBE_V2B_ARGS,
        })
    return _libs[name]
