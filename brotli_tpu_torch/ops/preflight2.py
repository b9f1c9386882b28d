"""Host preflight of the v2 decode path: a stream's header and tables
parsed on the host, and a batch of streams staged for the entropy kernel.

A copy of the numpy and C++ host half of the JAX package, so that the port
imports nothing of it:

* brotli_tpu/ops/device_decode.py:45-150 -- `PreflightResult`, `preflight`
  (Python parse) and `preflight_many` (one native call for a batch);
* brotli_tpu/ops/pallas_decode2.py:57-100 -- the phases, token tags, table
  chunk counts and `_build_consts`;
* brotli_tpu/ops/pallas_decode2.py:644-961 -- `SharedBatch`, `_parse_dedup`,
  `preflight_shared`, `preflight_binned`;
* brotli_tpu/ops/pallas_decode2.py:1036-1056 and 1094 -- `WIDX_SLACK`,
  `lane_overran` and `MAX_GROUPS`.

The staging keeps the reference's (8, 128) TPU layout; ops/decode2.py's
`batch_to_torch` turns it into the port's tensors.  The tests hold these
copies to the originals field by field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    COPY_LENGTH_N_BITS,
    COPY_LENGTH_OFFSET,
    DISTANCE_SHORT_CODE_DELTA,
    DISTANCE_SHORT_CODE_INDEX,
    INSERT_LENGTH_N_BITS,
    INSERT_LENGTH_OFFSET,
)
from ..decode.bitreader import BitReader, BrotliError
from ..decode.engine import (
    _MetablockState,
    _decode_window_bits,
    _read_metablock_length,
)

# padded table sizes (MAX_HUFFMAN_TABLE_SIZE for each alphabet class)
LIT_TABLE_SIZE = 630    # alphabet 256
CMD_TABLE_SIZE = 1080   # alphabet 704
DIST_TABLE_SIZE = 920   # alphabet <= 544
MAX_DIST_ALPHABET = 544


@dataclass
class PreflightResult:
    """Host-parsed stream prologue for device execution."""

    words: np.ndarray        # uint32 bit stream
    cmd_start_bit: int       # bit offset where the command loop starts
    mlen: int                # decoded size (single metablock)
    max_backward: int        # (1 << wbits) - 16
    lit_table: np.ndarray    # (LIT_TABLE_SIZE,) int32
    cmd_table: np.ndarray
    dist_table: np.ndarray
    dist_extra: np.ndarray   # (MAX_DIST_ALPHABET,) int8-ish
    dist_offset: np.ndarray  # (MAX_DIST_ALPHABET,) int32
    npostfix: int
    ndirect: int


def preflight(data: bytes) -> PreflightResult | None:
    """Parse stream header + first metablock tables; None if device-ineligible."""
    try:
        br = BitReader(bytes(data))
        wbits, is_large = _decode_window_bits(br, large_window_enabled=False)
        input_end = bool(br.read(1))
        if input_end and br.read(1):
            return None  # empty stream: trivial on host
        mlen, is_uncompressed, is_metadata = _read_metablock_length(br, input_end)
        if is_metadata or is_uncompressed or mlen == 0:
            return None
        if not input_end:
            # device path requires the single compressed metablock to be last
            # (a trailing empty last-block is handled after the device run by
            # the host validator; keep it simple: require ISLAST here)
            return None
        st = _MetablockState(br, large_window=False)
        if (
            st.num_types != [1, 1, 1]
            or len(st.lit_group) != 1
            or len(st.dist_group) != 1
            or not st.trivial_literal
        ):
            return None
    except BrotliError:
        return None

    def _pad(table: list[int], size: int) -> np.ndarray:
        out = np.zeros(size, dtype=np.int32)
        n = min(len(table), size)
        out[:n] = table[:n]
        return out

    dist_extra = np.zeros(MAX_DIST_ALPHABET, dtype=np.int32)
    dist_offset = np.zeros(MAX_DIST_ALPHABET, dtype=np.int32)
    n = min(len(st.dist_extra), MAX_DIST_ALPHABET)
    dist_extra[:n] = st.dist_extra[:n]
    dist_offset[:n] = st.dist_offset[:n]

    pad = (-len(data)) % 4 + 12
    words = np.frombuffer(bytes(data) + b"\x00" * pad, dtype="<u4")
    return PreflightResult(
        words=words,
        cmd_start_bit=br.bitpos,
        mlen=mlen,
        max_backward=(1 << wbits) - 16,
        lit_table=_pad(st.lit_group[0], LIT_TABLE_SIZE),
        cmd_table=_pad(st.cmd_group[0], CMD_TABLE_SIZE),
        dist_table=_pad(st.dist_group[0], DIST_TABLE_SIZE),
        dist_extra=dist_extra,
        dist_offset=dist_offset,
        npostfix=st.npostfix,
        ndirect=st.ndirect,
    )


def preflight_many(streams: list[bytes]) -> list[PreflightResult | None]:
    """Batch preflight via the native C++ header parser (decoder.cpp),
    one call for the whole batch — the per-stream Python parse cost
    ~1 ms/stream on the 1-core host (bench preflight_ms_per_batch).
    Falls back to the Python parser when the native library is missing."""
    try:
        from ..native import preflight_batch_native

        scal, lit, cmd, dist, dxe, dxo = preflight_batch_native(streams)
    except Exception:
        return [preflight(s) for s in streams]
    out: list[PreflightResult | None] = []
    for i, s in enumerate(streams):
        if scal[i, 0] != 1:
            out.append(None)
            continue
        pad = (-len(s)) % 4 + 12
        words = np.frombuffer(bytes(s) + b"\x00" * pad, dtype="<u4")
        out.append(PreflightResult(
            words=words, cmd_start_bit=int(scal[i, 2]), mlen=int(scal[i, 1]),
            max_backward=(1 << int(scal[i, 5])) - 16,
            lit_table=lit[i], cmd_table=cmd[i], dist_table=dist[i],
            dist_extra=dxe[i], dist_offset=dxo[i],
            npostfix=int(scal[i, 3]), ndirect=int(scal[i, 4]),
        ))
    return out


SUB = 8          # sublanes: stream rows
LANES = 128      # lanes: stream columns
NSTREAM = SUB * LANES

# phases
INIT, CMD, INS_EX, CP_EX, LIT, DIST, DIST_EX, DIST2, DONE, ERR = range(10)

# token tags
TAG_LIT = 0
TAG_COPY = 1 << 30
TAG_DIST = 2 << 30
TAG_FUSED = 3 << 30

LIT_K = 5    # 630-entry literal table -> 5 chunks of 128
CMD_K = 9    # 1080-entry command table
DIST_K = 8   # 920-entry distance table
DX_K = 5     # 544-entry packed distance (extra<<26)|offset lut


def _replicate(table: np.ndarray, k: int) -> np.ndarray:
    """(<=k*128,) int32 -> (k*8, 128) with each 128-entry chunk replicated
    across its 8 sublanes (lane-gather table layout)."""
    flat = np.zeros(k * 128, dtype=np.int32)
    flat[: table.shape[0]] = table
    chunks = flat.reshape(k, 1, 128)
    return np.broadcast_to(chunks, (k, SUB, 128)).reshape(k * SUB, 128).copy()


def _build_consts() -> np.ndarray:
    """(8,128) packed lut: [0..23] ins (nbits<<20|offset),
    [64..87] copy (nbits<<20|offset), [96..111] short ((ring_idx<<4)|(delta+3))."""
    c = np.zeros(128, dtype=np.int32)
    c[0:24] = (np.asarray(INSERT_LENGTH_N_BITS, np.int32) << 20) | np.asarray(
        INSERT_LENGTH_OFFSET, np.int32
    )
    c[64:88] = (np.asarray(COPY_LENGTH_N_BITS, np.int32) << 20) | np.asarray(
        COPY_LENGTH_OFFSET, np.int32
    )
    c[96:112] = (np.asarray(DISTANCE_SHORT_CODE_INDEX, np.int32) << 4) | (
        np.asarray(DISTANCE_SHORT_CODE_DELTA, np.int32) + 3
    )
    return np.broadcast_to(c[None, :], (SUB, 128)).copy()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class SharedBatch:
    wt: np.ndarray            # (Wpad, 8, 128) u32
    lit_t: np.ndarray         # (5*8, 128) i32
    cmd_t: np.ndarray
    dist_t: np.ndarray
    dx_t: np.ndarray
    consts: np.ndarray        # (8, 128) i32
    scal: np.ndarray          # (16, 128) i32: start_bit rows, mlen rows
    mlens: np.ndarray         # (NSTREAM,) int64
    n_streams: int
    npostfix: int
    ndirect: int
    maxbw: int
    Wpad: int
    groups: int = 1
    lit_k: int = LIT_K
    cmd_k: int = CMD_K
    dist_k: int = DIST_K
    dx_k: int = DX_K
    # perm[slot] = original stream index of lane slot (-1 = pad); identity
    # when no reordering happened
    perm: np.ndarray | None = None
    # per-slot count of real (non-padding) words in wt; lanes that consume
    # past this ran off the end of their own stream (see lane_overran)
    n_words: np.ndarray | None = None


def _parse_dedup(streams: list[bytes], max_sigs: int = 8):
    """Parse stream prologues with header dedup.

    encode_sharded batches share BYTE-IDENTICAL headers across equal-size
    chunks (same tables, same MLEN, same start bit), so one real parse plus
    a prefix memcmp covers the other 1023 lanes — this was the preflight
    wall (native parse 27 ms + table compares 16 ms per 1024-stream group,
    VERDICT r3 #2).  A signature is the header's full bytes plus the
    masked bits of its final partial byte; identical prefix bits imply an
    identical parse (the parse is a deterministic function of the prefix).
    Streams matching no signature after `max_sigs` distinct headers fall
    back to the native batch parser.

    Returns a list of PreflightResult where clones SHARE the parse's table
    arrays (identity, no copies) but carry no words — staging reads the
    stream bytes directly; or None if any stream is device-ineligible.
    """
    sigs = []  # (n_full_bytes, last_mask, prefix, masked_last, result)
    pres: list = [None] * len(streams)
    hard: list[int] = []
    for i, s in enumerate(streams):
        matched = False
        for nf, mask, pref, lastb, res in sigs:
            if len(s) > nf and s[:nf] == pref and (
                not mask or (s[nf] & mask) == lastb
            ):
                pres[i] = res
                matched = True
                break
        if matched:
            continue
        if len(sigs) < max_sigs:
            r = preflight(s)
            if r is None:
                return None
            nbits = r.cmd_start_bit
            nf, rem = nbits >> 3, nbits & 7
            mask = (1 << rem) - 1
            lastb = (s[nf] & mask) if rem and len(s) > nf else 0
            sigs.append((nf, mask, bytes(s[:nf]), lastb, r))
            pres[i] = r
        else:
            hard.append(i)
    if hard:
        sub = preflight_many([streams[i] for i in hard])
        if any(p is None for p in sub):
            return None
        for i, p in zip(hard, sub):
            pres[i] = p
    return pres


def preflight_shared(streams: list[bytes], D: int = 64,
                     groups: int = 1,
                     rate_sort: bool = False) -> SharedBatch | None:
    """Preflight a batch of <=1024*groups same-table streams.

    rate_sort assigns streams to lane slots ordered by compression rate
    (decoded bytes per compressed bit) — the dominant predictor of how many
    kernel rows a lane needs per output byte.  The LZ-resolve kernel bounds
    inter-lane output skew by its ring headroom (pallas_resolve.py), and
    measured batches of mixed text+font 8-32 KB chunks exceed it unsorted;
    sorting packs similar-rate lanes into the same interleave group, which
    keeps per-group skew well inside the bound.  Results map back through
    batch.perm.
    """
    if not streams or len(streams) > NSTREAM * groups:
        return None
    pres = _parse_dedup(streams)
    if pres is None:
        return None
    p0 = pres[0]
    for p in pres[1:]:
        if p is p0:  # dedup clone: identical by construction
            continue
        if (
            p.npostfix != p0.npostfix
            or p.ndirect != p0.ndirect
            or p.max_backward != p0.max_backward
            or not np.array_equal(p.lit_table, p0.lit_table)
            or not np.array_equal(p.cmd_table, p0.cmd_table)
            or not np.array_equal(p.dist_table, p0.dist_table)
        ):
            return None

    # rebase each stream's words to its command start word
    G = groups
    NT = NSTREAM * G
    order = list(range(len(pres)))
    if rate_sort:
        rate = [
            p.mlen / max(1, len(s)) for p, s in zip(pres, streams)
        ]
        order.sort(key=lambda i: rate[i])
    perm = np.full(NT, -1, dtype=np.int64)
    perm[: len(pres)] = order
    start_bits = np.zeros(NT, dtype=np.int32)
    mlens = np.zeros(NT, dtype=np.int64)
    n_words = np.zeros(NT, dtype=np.int32)
    for slot, i in enumerate(order):
        p = pres[i]
        w0 = p.cmd_start_bit >> 5
        start_bits[slot] = p.cmd_start_bit & 31
        mlens[slot] = p.mlen
        # matches the padded-frombuffer word count: ceil(len/4) + 3 tail
        n_words[slot] = -(-len(streams[i]) // 4) + 3 - w0
    max_words = int(n_words.max())
    Wpad = _round_up(max_words, D) + D
    # stage bodies slot-major (contiguous memcpy per lane), then one bulk
    # transpose into the kernel's word-major (Wpad, G*8, 128) layout —
    # measured 3-4x cheaper than 1024 strided scatters on the 1-core host
    buf = np.zeros((NT, Wpad * 4), dtype=np.uint8)
    for slot, i in enumerate(order):
        s = streams[i]
        w0 = pres[i].cmd_start_bit >> 5
        body = np.frombuffer(s, np.uint8)[4 * w0:]
        buf[slot, : body.shape[0]] = body
    wt = np.ascontiguousarray(
        buf.view("<u4").reshape(G, SUB, LANES, Wpad).transpose(3, 0, 1, 2)
    ).reshape(Wpad, G * SUB, LANES)

    dx = (np.asarray(p0.dist_extra, np.int32) << 26) | np.asarray(
        p0.dist_offset, np.int32
    )
    scal = np.zeros((2 * G * SUB, LANES), dtype=np.int32)
    for g in range(G):
        sb = start_bits[g * NSTREAM:(g + 1) * NSTREAM].reshape(SUB, LANES)
        ml = mlens[g * NSTREAM:(g + 1) * NSTREAM].reshape(SUB, LANES)
        scal[2 * g * SUB:(2 * g + 1) * SUB, :] = sb
        scal[(2 * g + 1) * SUB:(2 * g + 2) * SUB, :] = ml.astype(np.int32)
    def used_k(table, cap):
        # chunks actually occupied by this batch's (shared) tables
        n = len(table)
        while n > 1 and table[n - 1] == 0:
            n -= 1
        return max(2, min(cap, -(-n // 128)))  # >=2: root always addressable

    lit_k = used_k(p0.lit_table, LIT_K)
    cmd_k = used_k(p0.cmd_table, CMD_K)
    dist_k = used_k(p0.dist_table, DIST_K)
    # the kernel expects per-interleave-group table stacks; a fully shared
    # batch just tiles the one set G times (240 KB of VMEM at G=12)
    return SharedBatch(
        wt=wt,
        lit_t=np.tile(_replicate(p0.lit_table[: lit_k * 128], lit_k), (G, 1)),
        cmd_t=np.tile(_replicate(p0.cmd_table[: cmd_k * 128], cmd_k), (G, 1)),
        dist_t=np.tile(
            _replicate(p0.dist_table[: dist_k * 128], dist_k), (G, 1)
        ),
        dx_t=_replicate(dx, DX_K),
        groups=G,
        lit_k=lit_k, cmd_k=cmd_k, dist_k=dist_k, dx_k=DX_K,
        consts=_build_consts(),
        scal=scal,
        mlens=mlens,
        n_streams=len(streams),
        npostfix=p0.npostfix,
        ndirect=p0.ndirect,
        maxbw=p0.max_backward,
        Wpad=Wpad,
        perm=perm if rate_sort else None,
        n_words=n_words,
    )


def preflight_binned(streams: list[bytes],
                     max_groups: int | None = None, D: int = 64):
    """Bin arbitrary device-eligible streams by Huffman-table signature.

    Each interleave group of the v2 kernel carries its own table set, so a
    batch only needs PER-GROUP-identical tables: streams are bucketed by
    the exact (lit, cmd, dist) table bytes (npostfix/ndirect/max_backward
    must match batch-wide — they parameterize shared kernel constants).
    Returns (batch, perm) where perm[slot] is the original stream index of
    lane slot (slots g*1024+j in group-major order, -1 = pad lane), or
    None when the streams don't fit the constraints.

    Covers VERDICT round-1 item 4: mixed batches (several encode_sharded
    outputs, differently-tuned shards) decode on the fast path instead of
    degrading to the per-lane v1 kernel.
    """
    if max_groups is None:
        max_groups = MAX_GROUPS
    if not streams:
        return None
    pres = _parse_dedup(streams, max_sigs=16)
    if pres is None:
        return None
    p0 = pres[0]
    bins: dict[bytes, list[int]] = {}
    sig_cache: dict[int, bytes] = {}  # id(parse) -> table signature
    for i, p in enumerate(pres):
        if (p.npostfix != p0.npostfix or p.ndirect != p0.ndirect
                or p.max_backward != p0.max_backward):
            return None
        sig = sig_cache.get(id(p))
        if sig is None:
            sig = (p.lit_table.tobytes() + p.cmd_table.tobytes()
                   + p.dist_table.tobytes())
            sig_cache[id(p)] = sig
        bins.setdefault(sig, []).append(i)
    # each bin becomes ceil(len/1024) groups
    n_groups = sum(-(-len(v) // NSTREAM) for v in bins.values())
    if n_groups > max_groups:
        return None

    G = n_groups
    rebased, start_bits, mlens = [], np.zeros(G * NSTREAM, np.int32), \
        np.zeros(G * NSTREAM, np.int64)
    n_words = np.zeros(G * NSTREAM, np.int32)
    perm = np.full(G * NSTREAM, -1, np.int64)
    group_tabs = []
    slot_base = 0
    for sig, idxs in bins.items():
        # rate-sort within the bin: groups get similar-rate lanes (output
        # skew stays inside the resolve kernel's ring headroom)
        idxs.sort(key=lambda i: pres[i].mlen / max(1, len(streams[i])))
        rep = pres[idxs[0]]
        for off in range(0, len(idxs), NSTREAM):
            part = idxs[off : off + NSTREAM]
            group_tabs.append(rep)
            for j, i in enumerate(part):
                p = pres[i]
                slot = slot_base + j
                w0 = p.cmd_start_bit >> 5
                rebased.append((slot, i, w0))
                start_bits[slot] = p.cmd_start_bit & 31
                mlens[slot] = p.mlen
                n_words[slot] = -(-len(streams[i]) // 4) + 3 - w0
                perm[slot] = i
            slot_base += NSTREAM

    max_words = int(n_words.max())
    Wpad = _round_up(max_words, D) + D
    # slot-major byte staging + one bulk transpose (see preflight_shared);
    # clones from _parse_dedup share table arrays but each lane's body is
    # read straight from its own stream bytes
    buf = np.zeros((G * NSTREAM, Wpad * 4), dtype=np.uint8)
    for slot, i, w0 in rebased:
        body = np.frombuffer(streams[i], np.uint8)[4 * w0:]
        buf[slot, : body.shape[0]] = body
    wt = np.ascontiguousarray(
        buf.view("<u4").reshape(G, SUB, LANES, Wpad).transpose(3, 0, 1, 2)
    ).reshape(Wpad, G * SUB, LANES)

    def used_k(table, cap):
        n = len(table)
        while n > 1 and table[n - 1] == 0:
            n -= 1
        return max(2, min(cap, -(-n // 128)))

    lit_k = max(used_k(t.lit_table, LIT_K) for t in group_tabs)
    cmd_k = max(used_k(t.cmd_table, CMD_K) for t in group_tabs)
    dist_k = max(used_k(t.dist_table, DIST_K) for t in group_tabs)
    lit_t = np.concatenate(
        [_replicate(t.lit_table[: lit_k * 128], lit_k) for t in group_tabs]
    )
    cmd_t = np.concatenate(
        [_replicate(t.cmd_table[: cmd_k * 128], cmd_k) for t in group_tabs]
    )
    dist_t = np.concatenate(
        [_replicate(t.dist_table[: dist_k * 128], dist_k) for t in group_tabs]
    )
    dx = (np.asarray(p0.dist_extra, np.int32) << 26) | np.asarray(
        p0.dist_offset, np.int32
    )
    scal = np.zeros((2 * G * SUB, LANES), dtype=np.int32)
    for g in range(G):
        sb = start_bits[g * NSTREAM:(g + 1) * NSTREAM].reshape(SUB, LANES)
        ml = mlens[g * NSTREAM:(g + 1) * NSTREAM].reshape(SUB, LANES)
        scal[2 * g * SUB:(2 * g + 1) * SUB, :] = sb
        scal[(2 * g + 1) * SUB:(2 * g + 2) * SUB, :] = ml.astype(np.int32)
    batch = SharedBatch(
        wt=wt, lit_t=lit_t, cmd_t=cmd_t, dist_t=dist_t,
        dx_t=_replicate(dx, DX_K),
        groups=G, lit_k=lit_k, cmd_k=cmd_k, dist_k=dist_k, dx_k=DX_K,
        consts=_build_consts(), scal=scal, mlens=mlens,
        n_streams=len(streams),
        npostfix=p0.npostfix, ndirect=p0.ndirect, maxbw=p0.max_backward,
        Wpad=Wpad, perm=perm, n_words=n_words,
    )
    return batch, perm


# a live lane's 64-bit lookahead may pull a few padding words past its
# final content bits before the last command completes
WIDX_SLACK = 4


def lane_overran(batch: SharedBatch, widx) -> np.ndarray:
    """Per-slot bool: lane pulled words beyond its own stream (+slack).

    The batch word table is zero-padded to Wpad, so a TRUNCATED stream does
    not stop the kernel: zero bits keep decoding as valid-looking symbols
    and the lane can reach DONE with garbage bytes.  The reference errors
    with unexpected-EOF when the bitreader runs dry (engine.ts:2136-2144);
    the device analog is this host-side check of the status widx row
    against the lane's real word count — overrun lanes go to host decode,
    which raises the proper BrotliError.
    """
    if batch.n_words is None:
        return np.zeros(NSTREAM * batch.groups, dtype=bool)
    widx = np.asarray(widx).reshape(-1).astype(np.int64)
    return widx > batch.n_words.astype(np.int64) + WIDX_SLACK


MAX_GROUPS = 12  # measured sweet spot on v5e; 16 regresses (register spills)
