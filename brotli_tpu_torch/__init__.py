"""brotli_tpu_torch -- the device decode path of brotli_tpu in PyTorch/CUDA.

Ported (device half, hand-written CUDA for sm_90a, with a plain PyTorch
version of each kernel that CPU tensors take):

  ops/decode2.py  v2 entropy decode + the decode round trip
                  (brotli_tpu/ops/pallas_decode2.py), kernel csrc/decode2.cu
  ops/resolve.py  LZ resolve (brotli_tpu/ops/pallas_resolve.py),
                  kernel csrc/resolve.cu
  build.py        nvcc/g++ builds of csrc/, loaded with ctypes
  device.py       explicit device selection

Shared with brotli_tpu, not copied (numpy, Python and C++ through ctypes;
none of it imports JAX): the encoder (brotli_tpu.encode), the host decoder
(brotli_tpu.decode, brotli_tpu.native), the format tables
(brotli_tpu.constants) and the host preflight that stages a batch
(SharedBatch, preflight_shared, preflight_binned, lane_overran in
brotli_tpu.ops.pallas_decode2).  This package never imports jax.
`encode_sharded`, the encoder that makes the streams this path decodes, is
re-exported here so that a caller of the port needs no other import.
"""

from brotli_tpu.encode.sharded import encode_sharded

from .ops.decode2 import decode_batch_device_e2e, fallback_stats

__all__ = ["decode_batch_device_e2e", "encode_sharded", "fallback_stats"]
