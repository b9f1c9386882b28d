"""brotli_tpu_torch -- the device encoder and the device decode path of
brotli_tpu in PyTorch/CUDA.

Ported (hand-written CUDA for sm_90a, with a plain PyTorch version of each
kernel that CPU tensors take):

  ops/device_encode.py  the device encoder (brotli_tpu/ops/device_encode.py):
                        match finding, parse, records and histograms in
                        PyTorch, the bit-pack kernel csrc/pack.cu
  ops/decode2.py        v2 entropy decode + the decode round trip
                        (brotli_tpu/ops/pallas_decode2.py), kernel
                        csrc/decode2.cu
  ops/decode3.py        v3 full-format decode of single- and
                        multi-metablock streams
                        (brotli_tpu/ops/pallas_decode3.py), kernel
                        csrc/decode3.cu
  ops/resolve.py        LZ resolve (brotli_tpu/ops/pallas_resolve.py),
                        kernel csrc/resolve.cu
  ops/device_decode.py  per-lane-table decode of independently compressed
                        streams (brotli_tpu/ops/device_decode.py), kernel
                        csrc/device_decode.cu
  ops/preflight2_native.py
                        the v2 round trip's host preflight and staging in
                        C++ (native/preflight2.cpp, over threads): the
                        port's tensors in one pinned buffer and one copy
  ops/device_zopfli.py  the quality-10 Zopfli DP
                        (brotli_tpu/ops/device_zopfli.py): matches and
                        backtrack on the host, the node relaxation in
                        the kernel csrc/zopfli.cu
  parallel/mesh.py      device slots (one stream each; several a card with
                        logical=True) and the multi-device encode, v2 and
                        v3 decode over them (brotli_tpu/parallel/mesh.py)
  parallel/multihost.py the multi-process layer on torch.distributed (gloo)
                        (brotli_tpu/parallel/multihost.py)
  build.py              nvcc/g++ builds of csrc/, loaded with ctypes
  device.py             explicit device selection

The round trip on a card is
`decode_batch_device_e2e(encode_device_batch(data, device="cuda"),
device="cuda")`, which gives back the chunks of `data`; streams made with
`lit_ctx_trees > 1` or `block_types > 1` (context maps, block switching)
decode through `decode_batch_v3(streams, device="cuda")`, and streams of
several metablocks through `decode_batch_v3_full`.  Streams compressed
independently, each with tables of its own, decode through
`decode_batch_device(streams)`, and over device slots through
`sharded_decode_batch(streams, mesh)`.  Over several device
slots: `encode_batches_multichip(data, get_mesh(4, logical=True))` and
`decode_batches_multichip(streams, mesh)` (one card runs the four slots as
four CUDA streams).  `zopfli_commands_device(data)` gives the host q10
parse's commands and last insert for one stream, its DP on the card.

Self-contained: the port imports nothing of brotli_tpu and never imports
jax.  It keeps its own copy of the host code it needs (numpy, Python and
C++ through ctypes), in the reference's layout:

  constants.py, data/   format tables, static dictionary, transforms
  decode/, native/      the host decoder (Python and C++), the native
                        batch preflight and Huffman builders
  encode/, parallel/    the host encoder (quality 0-11, streaming,
                        shared-table chunks, spliced shards)
  ops/preflight2.py, ops/preflight3.py, ops/encode_host.py
                        the numpy host halves of the JAX ops modules
                        (batch staging, table and header building)

The tests hold every copy to its original.  The host codec is re-exported
here, under the JAX package's names, so that a caller of the port needs
no other import: `encode` (one stream at quality 0-11; also as
`host_encode`), `encode_fragment` (one stream of a spliced series),
`Encoder` (streaming), `encode_sharded` (shared-table chunk streams),
`encode_sharded_concat` (those chunks spliced into one stream),
`parallel_encode` (spliced fragments), `decode` (also as `host_decode`),
`decoded_size` and `BrotliError`.  The console script `brotli-tpu-torch`
(`python3 -m brotli_tpu_torch.cli encode|decode <in> [<out>]`) runs them
as `brotli-tpu` runs the JAX package's.

The drivers run on the card unless the caller passes device="cpu".
"""

from .decode import BrotliError, decode, decoded_size
from .decode import decode as host_decode
from .encode import Encoder, encode, encode_fragment
from .encode import encode as host_encode
from .encode.sharded import encode_sharded, encode_sharded_concat
from .ops.decode2 import (decode_batch_device_e2e, decode_batch_pallas2,
                          fallback_stats)
from .ops.decode3 import (decode_batch_v3, decode_batch_v3_full,
                          stage_dictionary)
from .ops.device_decode import decode_batch_device
from .ops.device_encode import encode_device_batch, encode_fallback_stats
from .ops.device_zopfli import zopfli_commands_device
from .parallel import (broadcast_dictionary, broadcast_dictionary_chunks,
                       decode_batch_v3_multichip, decode_batches_multichip,
                       decode_multihost, encode_batches_multichip,
                       encode_multihost, get_local_mesh, get_mesh,
                       init_multihost, parallel_encode, sharded_decode_batch)


def encode_sharded_device(data, **kw):
    """The device encoder under the JAX package's other name for it:
    encode_device_batch(data, **kw)."""
    return encode_device_batch(data, **kw)


# the version of pyproject.toml, which both packages share
__version__ = "0.2.0"

__all__ = ["BrotliError", "Encoder", "__version__", "broadcast_dictionary",
           "broadcast_dictionary_chunks", "decode", "decode_batch_device",
           "decode_batch_device_e2e",
           "decode_batch_pallas2", "decode_batch_v3", "decode_batch_v3_full",
           "decode_batch_v3_multichip", "decode_batches_multichip",
           "decode_multihost", "decoded_size", "encode",
           "encode_batches_multichip", "encode_device_batch",
           "encode_fallback_stats", "encode_fragment", "encode_multihost",
           "encode_sharded", "encode_sharded_concat",
           "encode_sharded_device", "fallback_stats",
           "get_local_mesh", "get_mesh", "host_decode", "host_encode",
           "init_multihost", "parallel_encode", "sharded_decode_batch",
           "stage_dictionary", "zopfli_commands_device"]
