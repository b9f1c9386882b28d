"""Command-line interface: `brotli-tpu-torch encode|decode <in> [<out>]`.

    python3 -m brotli_tpu_torch.cli encode data.bin          # -> data.bin.br
    python3 -m brotli_tpu_torch.cli decode data.bin.br       # -> data.bin

The counterpart of brotli_tpu/cli.py: the same subcommands, options,
output names and stderr line, over the port's own copy of the host codec
(encode.encode, encode.sharded.encode_sharded_concat, decode.decode), so
its output is byte for byte the JAX package's.  Like that CLI it does no
device work; a `--sharded` stream decodes on the card through
decode_batch_v3_full.  A malformed stream raises BrotliError.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="brotli-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="compress a file")
    pe.add_argument("infile")
    pe.add_argument("outfile", nargs="?", help="default: <infile>.br")
    pe.add_argument("-q", "--quality", type=int, default=11)
    pe.add_argument("--lgwin", type=int, default=None)
    pe.add_argument("--mode", type=int, default=0,
                    help="0=GENERIC 1=TEXT 2=FONT")
    pe.add_argument("--sharded", action="store_true",
                    help="device-throughput layout: one spliced stream of "
                         "shared-table chunks (device-decodable)")

    pd = sub.add_parser("decode", help="decompress a file")
    pd.add_argument("infile")
    pd.add_argument("outfile", nargs="?", help="default: strip .br")
    pd.add_argument("--max-output-size", type=int, default=None)

    args = p.parse_args(argv)

    with open(args.infile, "rb") as f:
        data = f.read()
    if args.cmd == "encode":
        if args.sharded:
            from .encode.sharded import encode_sharded_concat

            out = encode_sharded_concat(data)
        else:
            from .encode import encode

            out = encode(data, quality=args.quality, lgwin=args.lgwin,
                         mode=args.mode)
        outfile = args.outfile or args.infile + ".br"
    else:
        from .decode import decode

        out = decode(data, max_output_size=args.max_output_size)
        outfile = args.outfile or (
            args.infile[:-3] if args.infile.endswith(".br")
            else args.infile + ".out"
        )
    with open(outfile, "wb") as f:
        f.write(out)
    print(f"{len(data)} -> {len(out)} bytes ({outfile})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
