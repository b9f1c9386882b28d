"""The port's multi-process layer (brotli_tpu_torch/parallel/multihost.py
and brotli_tpu_torch/tools/multihost_sim.py) on the CPU: real OS processes
joined by torch.distributed over gloo on 127.0.0.1.

Tolerance: exact equality.  Every process must get back the whole ordered
list: the streams equal to the JAX package's encode_sharded of each piece,
the decoded list equal to the data and to the single-process port's
decode_batches_multichip.  Every subprocess runs under a timeout, so a
hung rendezvous fails the test in about a minute and a half.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

from brotli_tpu.encode.sharded import encode_sharded
from brotli_tpu_torch.parallel.mesh import decode_batches_multichip, get_mesh
from brotli_tpu_torch.tools.multihost_sim import free_port, list_digest
from brotli_tpu_torch.utils.benchmarks import corpus

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 90

# rows by owner: rank 0 owns 0 (5 B), 2 (empty) and 5 (300 B); rank 1 owns
# 1 (1 B) and 3 (40 B); nobody owns 4 or 6
ROWS = {0: {0: b"\x07" * 5, 2: b"", 5: bytes(range(256)) + b"\xff" * 44},
        1: {1: b"\x08", 3: b"tail bytes of rank one, forty long......"}}
N_TOTAL = 7

GATHER = textwrap.dedent("""
    import json, sys
    from datetime import timedelta
    import torch.distributed as dist
    from brotli_tpu_torch.parallel.multihost import _allgather_bytes
    rank, port, rows = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=60))
    try:
        mine = [None] * int(sys.argv[4])
        for i, h in rows.items():
            mine[int(i)] = bytes.fromhex(h)
        out = _allgather_bytes(mine, len(mine))
    finally:
        dist.destroy_process_group()
    print(json.dumps([b.hex() for b in out]))
""")


def _run_all(cmds):
    """Start every command, wait for each under TIMEOUT; kill all on a
    timeout.  Returns the finished processes' (rc, stdout, stderr)."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return [(p.returncode, *o) for p, o in zip(procs, outs)]


def test_allgather_bytes_two_processes():
    port = str(free_port())
    res = _run_all([
        [sys.executable, "-c", GATHER, str(rank), port,
         json.dumps({str(i): b.hex() for i, b in ROWS[rank].items()}),
         str(N_TOTAL)]
        for rank in (0, 1)])
    want = [b""] * N_TOTAL
    for rows in ROWS.values():
        for i, b in rows.items():
            want[i] = b
    for rc, out, err in res:
        assert rc == 0, err[-2000:]
        assert [bytes.fromhex(h) for h in json.loads(out)] == want


def test_multihost_sim_cpu_two_processes():
    """2 processes x 2 slots, 8 KB in 512-byte chunks, pieces of 4 chunks
    encoded on the host, groups of 2 streams decoded on the CPU."""
    chunk, n_streams, piece = 512, 16, 4
    res = _run_all([[
        sys.executable, "-m", "brotli_tpu_torch.tools.multihost_sim",
        "--device", "cpu", "--streams", str(n_streams), "--chunk", str(chunk),
        "--piece-streams", str(piece), "--group-size", "2",
        "--backend", "host", "--timeout", str(TIMEOUT - 10)]])
    rc, out, err = res[0]
    assert rc == 0, out + err[-2000:]
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    workers, summary = lines[:-1], lines[-1]
    assert summary["multihost_sim"] == "ok"
    assert sorted(w["process"] for w in workers) == [0, 1]

    data = corpus(n_streams * chunk)
    step = piece * chunk
    streams = [s for off in range(0, len(data), step)
               for s in encode_sharded(data[off: off + step],
                                       chunk_size=chunk)]
    single = decode_batches_multichip(streams, get_mesh(2, "cpu"),
                                      group_size=2)
    chunks = [data[i: i + chunk] for i in range(0, len(data), chunk)]
    assert single == chunks
    for w in workers:
        assert w["roundtrip_ok"] and w["streams"] == n_streams
        assert w["streams_sha256"] == list_digest(streams)
        assert w["decoded_sha256"] == list_digest(single)
