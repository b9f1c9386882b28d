"""Multi-process codec round trip: 2 processes x 2 device slots.

    python -m brotli_tpu_torch.tools.multihost_sim [--device cpu|cuda]
        [--streams S] [--chunk C] [--piece-streams P] [--group-size G]
        [--backend device|host] [--timeout SECONDS]

Counterpart of tools/multihost_sim.py.  Starts two worker processes
joined by torch.distributed (gloo, a free port on 127.0.0.1), each with
two logical slots on its device (parallel/multihost.py): every worker
encodes the pieces it owns (encode_multihost), decodes the groups it owns
(decode_multihost), and gets back the whole ordered list.  The data is
S x C bytes of the in-repo corpus (utils/benchmarks.corpus).

Prints one JSON line per worker (its rank, whether its decoded list
equals the data, the SHA-256 of its encoded and decoded lists, its wall
seconds) and, last, a summary line.  Exits non-zero when a worker fails,
when the workers' lists differ, or when a worker outlasts the timeout
(then every worker is killed).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROCESSES = 2
SLOTS = 2    # logical slots a process


def list_digest(items: list[bytes]) -> str:
    """SHA-256 over a list of byte strings, each with its length."""
    h = hashlib.sha256()
    for b in items:
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return h.hexdigest()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--streams", type=int, default=4 * 1024)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--piece-streams", type=int, default=None)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--backend", default="device", choices=("device", "host"))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, nargs=2, metavar=("RANK", "PORT"),
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def worker(args: argparse.Namespace) -> int:
    import torch.distributed as dist

    from brotli_tpu_torch.parallel.multihost import (decode_multihost,
                                                     encode_multihost,
                                                     init_multihost)
    from brotli_tpu_torch.utils.benchmarks import corpus

    rank, port = args.worker
    init_multihost(f"127.0.0.1:{port}", rank, PROCESSES,
                   local_devices=SLOTS, device=args.device,
                   timeout_s=args.timeout)
    try:
        data = corpus(args.streams * args.chunk)
        t0 = time.perf_counter()
        streams = encode_multihost(data, chunk_size=args.chunk,
                                   piece_streams=args.piece_streams,
                                   backend=args.backend)
        got = decode_multihost(streams, group_size=args.group_size)
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    ok = b"".join(got) == data
    print(json.dumps({"process": rank, "roundtrip_ok": ok,
                      "streams": len(streams),
                      "streams_sha256": list_digest(streams),
                      "decoded_sha256": list_digest(got),
                      "wall_s": wall}), flush=True)
    return 0 if ok else 1


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker is not None:
        return worker(args)
    argv = list(sys.argv[1:] if argv is None else argv)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "brotli_tpu_torch.tools.multihost_sim",
         *argv, "--worker", str(rank), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT, env=env)
        for rank in range(PROCESSES)]
    timed_out = False
    outs = []
    for p in procs:
        left = max(1.0, args.timeout - (time.perf_counter() - t0))
        try:
            outs.append(p.communicate(timeout=left))
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            outs.append(p.communicate(timeout=60))
    workers = []
    for (so, se), p in zip(outs, procs):
        for line in so.decode().splitlines():
            if line.startswith("{"):
                workers.append(json.loads(line))
                print(line)
        if p.returncode != 0:
            sys.stderr.write(se.decode()[-3000:])
    same = len({(w["streams_sha256"], w["decoded_sha256"])
                for w in workers}) == 1
    ok = (not timed_out and all(p.returncode == 0 for p in procs)
          and len(workers) == PROCESSES and same
          and all(w["roundtrip_ok"] for w in workers))
    print(json.dumps({
        "multihost_sim": "ok" if ok else "FAILED", "timed_out": timed_out,
        "device": args.device, "processes": PROCESSES,
        "slots_per_process": SLOTS, "backend": args.backend,
        "bytes": args.streams * args.chunk,
        "wall_s": time.perf_counter() - t0,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
