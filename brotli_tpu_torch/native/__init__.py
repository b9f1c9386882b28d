"""Native (C++) host components, built on first use and loaded via ctypes.

A copy of brotli_tpu/native/__init__.py and its three C++ sources: the
host decoder, the batch header preflight, the Huffman and context-map
builders of the encoder, and the host LZ resolver.  The only change is
where the library is built: into brotli_tpu_torch/build/ through
build._build, not beside the sources.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_LIB: ctypes.CDLL | None = None


def _build() -> Path:
    """Compile the native library into the port's build directory, gated
    on a hash of the sources and the command (build._build: a private name
    renamed into place, so concurrent processes never load a half-written
    library).

    The hash stamp guarantees the loaded .so matches the checked-out sources
    and was built on this host (-march=native).
    """
    from ..build import _build as build_lib

    srcs = [_DIR / "lz_resolve.cpp", _DIR / "decoder.cpp",
            _DIR / "table_builder.cpp"]
    return build_lib(
        "brotli_tpu_torch_native",
        ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread"],
        ["g++", "-shared", "-pthread"], srcs)


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        fn = lib.lz_resolve_batch_v2
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
        pf = lib.brotli_native_preflight_batch
        pf.restype = ctypes.c_int
        pf.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_void_p] * 6
        )
        dec = lib.brotli_native_decode
        dec.restype = ctypes.c_int
        dec.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 12
            + [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int32]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
            + [ctypes.c_int32]
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        )
        bh = lib.native_build_huffman_code
        bh.restype = None
        bh.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        cc = lib.native_cluster_context_map
        cc.restype = ctypes.c_int
        cc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def build_huffman_code_native(histogram, alphabet_size: int):
    """Bit-identical native analog of entropy.build_huffman_code (same
    count-limit retry + tie-breaking); returns (depths, bits, count, s4)
    as python lists for drop-in use."""
    import numpy as np

    h = np.ascontiguousarray(np.asarray(histogram, np.int64)[:alphabet_size])
    if h.shape[0] < alphabet_size:
        h = np.concatenate([h, np.zeros(alphabet_size - h.shape[0], np.int64)])
    nz = np.flatnonzero(h)
    count = int(nz.shape[0])
    s4 = [0, 0, 0, 0]
    for k in range(min(4, count)):
        s4[k] = int(nz[k])
    if count <= 1:
        return [0] * alphabet_size, [0] * alphabet_size, count, s4
    lib = get_lib()
    depths = np.zeros(alphabet_size, np.uint8)
    bits = np.zeros(alphabet_size, np.uint16)
    lib.native_build_huffman_code(
        h.ctypes.data, alphabet_size, depths.ctypes.data, bits.ctypes.data
    )
    return depths.astype(np.int64).tolist(), bits.astype(np.int64).tolist(), \
        count, s4


def cluster_context_map_native(hists, rows: int, syms: int):
    """Bit-identical native analog of
    metablock_full._cluster_and_build_context_map; returns
    (num_clusters, context_map list)."""
    import numpy as np

    if rows <= 1:
        return 1, [0] * max(1, rows)
    arr = np.ascontiguousarray(np.asarray(hists, np.int64).reshape(rows, syms))
    cmap = np.zeros(rows, np.int32)
    lib = get_lib()
    n = lib.native_cluster_context_map(
        arr.ctypes.data, rows, syms, 64, cmap.ctypes.data
    )
    return int(n), cmap.astype(np.int64).tolist()


def lz_resolve_batch_v2(tokens, expected_lens, n_threads: int = 8):
    """Resolve (n_rows, n_lanes) u32 v2 tokens -> (n_lanes, cap) u8 outputs.

    `expected_lens[lane]` is the decoded size (known from the metablock
    header); resolution stops there. Returns (out, lens) where
    lens[lane] == -1 marks a malformed lane.  Token format:
    ops/pallas_decode2.py module docstring.
    """
    import numpy as np

    tokens = np.ascontiguousarray(tokens, dtype=np.uint32)
    n_rows, n_lanes = tokens.shape
    lens = np.asarray(expected_lens, dtype=np.int64).copy()
    assert lens.shape == (n_lanes,)
    cap = max(1, int(lens.max()))
    out = np.zeros((n_lanes, cap), dtype=np.uint8)
    lib = get_lib()
    lib.lz_resolve_batch_v2(
        tokens.ctypes.data_as(ctypes.c_void_p),
        n_rows, n_lanes,
        out.ctypes.data_as(ctypes.c_void_p),
        cap,
        lens.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    return out, lens


def preflight_batch_native(streams):
    """Parse all streams' headers + first-metablock tables in one native
    call; returns (scalars (n,8) i64, lit (n,630), cmd (n,1080),
    dist (n,920), dist_extra (n,544), dist_offset (n,544)).

    scalars rows: [eligible, mlen, cmd_start_bit, npostfix, ndirect,
    wbits, 0, 0] — eligible means v2-device-eligible (single compressed
    ISLAST metablock, trivial entropy layout)."""
    import numpy as np

    lib = get_lib()
    T = _decoder_tables()
    n = len(streams)
    data = np.frombuffer(b"".join(streams) + b"\x00", dtype=np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    for i, s in enumerate(streams):
        offsets[i + 1] = offsets[i] + len(s)
    lit = np.zeros((n, 630), np.int32)
    cmd = np.zeros((n, 1080), np.int32)
    dist = np.zeros((n, 920), np.int32)
    dxe = np.zeros((n, 544), np.int32)
    dxo = np.zeros((n, 544), np.int32)
    scal = np.zeros((n, 8), np.int64)
    p = ctypes.c_void_p
    lib.brotli_native_preflight_batch(
        data.ctypes.data_as(p), offsets.ctypes.data_as(p), n,
        T["blen_nbits"].ctypes.data_as(p), T["blen_offset"].ctypes.data_as(p),
        T["clc_order"].ctypes.data_as(p), T["clc_lengths"].ctypes.data_as(p),
        lit.ctypes.data_as(p), cmd.ctypes.data_as(p), dist.ctypes.data_as(p),
        dxe.ctypes.data_as(p), dxo.ctypes.data_as(p),
        scal.ctypes.data_as(p),
    )
    return scal, lit, cmd, dist, dxe, dxo


# ---------------------------------------------------------------------------
# native host decoder (decoder.cpp)
# ---------------------------------------------------------------------------

_DEC_TABLES = None


def _decoder_tables():
    """Flat ctypes-ready format tables (single source of truth: constants.py)."""
    global _DEC_TABLES
    if _DEC_TABLES is None:
        import numpy as np

        from ..constants import (
            BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET, CMD_LUT,
            CODE_LENGTH_CODE_LENGTHS, CODE_LENGTH_CODE_ORDER,
            COPY_LENGTH_N_BITS, COPY_LENGTH_OFFSET,
            DICT_OFFSETS_BY_LENGTH, DICT_SIZE_BITS_BY_LENGTH,
            INSERT_LENGTH_N_BITS, INSERT_LENGTH_OFFSET,
        )
        from ..decode.dictionary import get_dictionary
        from ..decode.engine import _CONTEXT_LUT
        from ..decode.transforms import TRANSFORM_LIST

        storage = bytearray()
        spans = np.zeros((len(TRANSFORM_LIST), 4), dtype=np.int32)
        ops = np.zeros(len(TRANSFORM_LIST), dtype=np.int32)
        for i, (pre, op, suf) in enumerate(TRANSFORM_LIST):
            spans[i, 0] = len(storage); spans[i, 1] = len(pre)
            storage.extend(pre)
            spans[i, 2] = len(storage); spans[i, 3] = len(suf)
            storage.extend(suf)
            ops[i] = op

        def i32(x):
            return np.ascontiguousarray(np.asarray(x, dtype=np.int32))

        _DEC_TABLES = dict(
            ins_nbits=i32(INSERT_LENGTH_N_BITS), ins_offset=i32(INSERT_LENGTH_OFFSET),
            cp_nbits=i32(COPY_LENGTH_N_BITS), cp_offset=i32(COPY_LENGTH_OFFSET),
            blen_nbits=i32(BLOCK_LENGTH_N_BITS), blen_offset=i32(BLOCK_LENGTH_OFFSET),
            cmd_lut=i32(CMD_LUT).reshape(-1), context_lut=i32(_CONTEXT_LUT),
            clc_order=i32(CODE_LENGTH_CODE_ORDER), clc_lengths=i32(CODE_LENGTH_CODE_LENGTHS),
            dict_offsets=i32(DICT_OFFSETS_BY_LENGTH), dict_sizebits=i32(DICT_SIZE_BITS_BY_LENGTH),
            dict_data=np.frombuffer(get_dictionary(), dtype=np.uint8),
            tf_spans=spans.reshape(-1), tf_ops=ops,
            tf_storage=np.frombuffer(bytes(storage) + b"\x00", dtype=np.uint8),
        )
    return _DEC_TABLES


def native_decode(data: bytes, custom_dictionary=None,
                  large_window: bool = False) -> bytes:
    """Decode via the C++ host decoder; raises BrotliError on failure."""
    import numpy as np

    from ..decode.bitreader import BrotliError

    lib = get_lib()
    if not hasattr(lib, "brotli_native_decode"):
        raise RuntimeError("native decoder missing")
    T = _decoder_tables()

    cd_chunks = []
    if custom_dictionary is not None:
        cd_chunks = (
            [bytes(custom_dictionary)]
            if isinstance(custom_dictionary, (bytes, bytearray, memoryview))
            else [bytes(c) for c in custom_dictionary]
        )
        if len(cd_chunks) > 15:
            raise BrotliError(-27, "too many dictionary chunks")
    cd_data = np.frombuffer(b"".join(cd_chunks) + b"\x00", dtype=np.uint8)
    cd_offsets = np.zeros(len(cd_chunks) + 1, dtype=np.int64)
    for i, c in enumerate(cd_chunks):
        cd_offsets[i + 1] = cd_offsets[i] + len(c)

    buf = np.frombuffer(bytes(data) + b"\x00", dtype=np.uint8)
    cap = max(len(data) * 6 + (1 << 20), 1 << 16)
    for _ in range(4):
        out = np.zeros(cap, dtype=np.uint8)
        out_len = ctypes.c_int64(0)
        p = ctypes.c_void_p
        rc = lib.brotli_native_decode(
            buf.ctypes.data_as(p), len(data),
            T["ins_nbits"].ctypes.data_as(p), T["ins_offset"].ctypes.data_as(p),
            T["cp_nbits"].ctypes.data_as(p), T["cp_offset"].ctypes.data_as(p),
            T["blen_nbits"].ctypes.data_as(p), T["blen_offset"].ctypes.data_as(p),
            T["cmd_lut"].ctypes.data_as(p), T["context_lut"].ctypes.data_as(p),
            T["clc_order"].ctypes.data_as(p), T["clc_lengths"].ctypes.data_as(p),
            T["dict_offsets"].ctypes.data_as(p), T["dict_sizebits"].ctypes.data_as(p),
            T["dict_data"].ctypes.data_as(p), len(T["dict_data"]),
            T["tf_spans"].ctypes.data_as(p), T["tf_ops"].ctypes.data_as(p),
            T["tf_storage"].ctypes.data_as(p), len(T["tf_ops"]),
            cd_data.ctypes.data_as(p), cd_offsets.ctypes.data_as(p),
            len(cd_chunks),
            1 if large_window else 0,
            out.ctypes.data_as(p), cap, ctypes.byref(out_len),
        )
        if rc == -1000:
            cap = max(cap * 2, int(out_len.value) + 64)
            continue
        if rc != 0:
            raise BrotliError(rc)
        return out[: out_len.value].tobytes()
    raise BrotliError(-1, "output capacity retry exhausted")
