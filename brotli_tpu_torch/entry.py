"""The port's entry point, the counterpart of __graft_entry__.entry().

`entry()` returns the flagship device component, the v2 entropy kernel
(ops/decode2.py `entropy_decode`, csrc/decode2.cu), with a staged batch of
32 shared-table streams on the card: `fn(*args)` decodes them to tokens.
The counterpart of `dryrun_multichip` waits for the multi-device slice.
"""

from __future__ import annotations

import torch


def example_shared_batch():
    """(data, streams, batch): 32 chunks of 512 B of repeated text as
    shared-table streams and their preflight (__graft_entry__'s batch)."""
    from .encode.sharded import encode_sharded
    from .ops.preflight2 import preflight_shared

    data = (b"the quick brown fox jumps over the lazy dog. " * 512)[:32 * 512]
    streams = encode_sharded(data, chunk_size=512)
    batch = preflight_shared(streams)
    if batch is None:
        raise RuntimeError("preflight_shared refused the example batch")
    return data, streams, batch


def entry(device: torch.device | str = "cuda"):
    """Returns (fn, args): the v2 entropy kernel and the example batch
    staged on `device` (the card unless the caller asks for the CPU, where
    fn is the kernel's plain version).  fn(*args) gives (tokens, counts,
    phases, words consumed) per lane."""
    from .ops.decode2 import batch_to_torch, entropy_decode

    _, _, batch = example_shared_batch()
    return entropy_decode, (batch_to_torch(batch, device),)
