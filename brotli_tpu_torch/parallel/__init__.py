"""Parallel host encode: independent metablock shards spliced into one
stream (shard.py, a copy of brotli_tpu/parallel/shard.py)."""
