"""Brotli decode pipeline (native C++ fast path + python golden path).

Public API mirrors the reference's decode subpath
(the reference library's src/decode/decode.ts:9-68):
  decode(data, ...)        <-> brotliDecode
  decoded_size(data)       <-> brotliDecodedSize

The host decode runs through the native C++ decoder (native/decoder.cpp,
~30x the python engine on this host); the python engine (engine.py) is the
golden implementation and the fallback when the native library cannot be
built. Set BROTLI_TPU_NO_NATIVE=1 to force the python path.
"""

from __future__ import annotations

import os

from .bitreader import BitReader, BrotliError
from .engine import decode as _engine_decode
from .engine import _decode_window_bits, _read_metablock_length

_native_decode = None
_native_checked = False


def _get_native():
    global _native_decode, _native_checked
    if not _native_checked:
        _native_checked = True
        if os.environ.get("BROTLI_TPU_NO_NATIVE") != "1":
            try:
                from ..native import native_decode as nd

                nd(b"\x21\x03\x00")  # tiny empty-ish probe builds the .so
                _native_decode = nd
            except BrotliError:
                from ..native import native_decode as nd

                _native_decode = nd  # probe decoded/erred through native: OK
            except Exception:
                _native_decode = None
    return _native_decode


def decode(
    data: bytes,
    *,
    custom_dictionary: bytes | list[bytes] | None = None,
    max_output_size: int | None = None,
    large_window: bool = False,
) -> bytes:
    """Decode a Brotli stream.

    `max_output_size` is enforced both via the size pre-peek and after
    decoding (reference decode.ts:30-52 does the same pre/post checks).
    """
    if max_output_size is not None:
        peeked = decoded_size(data)
        if peeked >= 0 and peeked > max_output_size:
            raise BrotliError(-28, "output larger than maxOutputSize")
    native = _get_native()
    if native is not None:
        out = native(
            data, custom_dictionary=custom_dictionary, large_window=large_window
        )
    else:
        out = _engine_decode(
            data, custom_dictionary=custom_dictionary, large_window=large_window
        )
    if max_output_size is not None and len(out) > max_output_size:
        raise BrotliError(-28, "output larger than maxOutputSize")
    return out


def decoded_size(data: bytes) -> int:
    """Byte size of the decoded stream if cheaply knowable, else -1.

    Exact semantics of the reference's size peek (engine.ts:2155-2192):
    known only for empty streams and single-metablock (ISLAST-first) streams.
    """
    if len(data) == 0:
        return -1
    try:
        br = BitReader(bytes(data))
        _decode_window_bits(br, large_window_enabled=False)
        input_end = bool(br.read(1))
        if input_end and br.read(1):
            return 0  # ISLAST + ISLASTEMPTY
        if not input_end:
            return -1
        mbl, _, is_metadata = _read_metablock_length(br, input_end)
        if is_metadata:
            return -1
        return mbl
    except BrotliError:
        return -1


__all__ = ["decode", "decoded_size", "BrotliError"]
