"""Scale-out: device slots and the multi-device batch encode and decode
over them, the per-lane-table decode's shards included (mesh.py), the
multi-process layer over torch.distributed (multihost.py), and parallel host encode of independent metablock shards spliced into one
stream (shard.py, a copy of brotli_tpu/parallel/shard.py)."""

from .mesh import (Slot, broadcast_dictionary, broadcast_dictionary_chunks,
                   decode_batch_v3_multichip, decode_batches_multichip,
                   encode_batches_multichip, get_mesh,
                   sharded_decode_batch)
from .multihost import (decode_multihost, encode_multihost, get_local_mesh,
                        init_multihost)
from .shard import parallel_encode, shard_file

__all__ = ["Slot", "broadcast_dictionary", "broadcast_dictionary_chunks",
           "decode_batch_v3_multichip", "decode_batches_multichip",
           "decode_multihost", "encode_batches_multichip", "encode_multihost",
           "get_local_mesh", "get_mesh", "init_multihost", "parallel_encode",
           "shard_file", "sharded_decode_batch"]
