"""Host preflight of the v3 full-format decode: each stream's metablock
header and tables parsed on the host, and the streams binned by table
signature into groups of 1024 lanes (`V3Batch`).

A copy of the numpy host half of brotli_tpu/ops/pallas_decode3.py, so that
the port imports nothing of the JAX package:

* lines 66-485 -- the phases, table chunk counts, status and error
  constants, the consts / context LUT / dictionary / transform tables,
  `GroupCfg`, `V3Batch`, `preflight_one_v3`, `_sig_of`, `_EntryV3`,
  `assemble_v3`, `preflight_v3` (without the TPU kernel's `FLUSH`,
  `STAG_LIMIT` and `FW` and the unused `_cm_chunks`);
* lines 1618-1625 -- `_compound_flat`;
* lines 1770-1785 -- the multi-metablock path's caps and `_caps_full_ok`.

The staging keeps the reference's (8, 128) TPU layout; ops/decode3.py's
`batch_to_torch_v3` turns it into the port's tensors.  The tests hold these
copies to the originals field by field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    BLOCK_LENGTH_N_BITS,
    BLOCK_LENGTH_OFFSET,
    COPY_LENGTH_N_BITS,
    COPY_LENGTH_OFFSET,
    DICT_OFFSETS_BY_LENGTH,
    DICT_SIZE_BITS_BY_LENGTH,
    DISTANCE_SHORT_CODE_DELTA,
    DISTANCE_SHORT_CODE_INDEX,
    INSERT_LENGTH_N_BITS,
    INSERT_LENGTH_OFFSET,
)

SUB = 8
LANES = 128
NSTREAM = SUB * LANES

# phases
INIT, CMD, INS_EX, CP_EX, LIT, DIST, DIST_EX, BSW2, DICT, DONE = range(10)

# chunks per tree (tables padded to chunk multiples of 128 entries)
LCH = 5    # literal tree: table 631
CCH = 9    # command tree: 1081
DCH = 8    # distance tree: 921
BTCH = 6   # block-type tree: alphabet <= 258 -> 663
BLCH = 4   # block-length tree: alphabet 26 -> 403
CMCH = 6   # cmap region: 4 lit cmap + 1 dist cmap + 1 modes(clo)

TAIL = 16                # status rows per group appended after the output
SCAL_ROWS = 12           # per-group scalar rows (see preflight_v3)

# lane error flags
ERR_FAR_DIST = 1         # copy distance beyond ring + flushed history
ERR_STREAM = 8           # malformed stream (bad distance/copy/transform)

_DICT_WORDS = None


def _replicate(flat: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros(k * 128, dtype=np.int32)
    out[: flat.shape[0]] = flat
    chunks = out.reshape(k, 1, 128)
    return np.broadcast_to(chunks, (k, SUB, 128)).reshape(k * SUB, 128).copy()


def _pad_table(table, chunks: int) -> np.ndarray:
    out = np.zeros(chunks * 128, dtype=np.int32)
    arr = np.asarray(table, np.int64)
    assert arr.shape[0] <= out.shape[0], \
        f"table {arr.shape[0]} entries > {chunks} chunks"
    out[: arr.shape[0]] = arr.astype(np.int32)
    return out


def _lcmch(nbt0: int) -> int:
    """Literal-context-map chunks for nbt0 block types (64 ctx each)."""
    return max(4, -(-nbt0 * 64 // 128))


def _dcmch(nbt2: int) -> int:
    """Distance-context-map chunks for nbt2 block types (4 ctx each)."""
    return max(1, -(-nbt2 * 4 // 128))



def _build_consts() -> np.ndarray:
    """(16,128) packed luts, 2 chunks:
    chunk 0: [0:24] ins (nbits<<20|off), [64:88] copy, [96:112] short codes
    chunk 1: [0:26] blen (nbits<<20|off), [32:64] dict size_bits,
             [64:96] dict word offsets (raw i32)"""
    c = np.zeros(256, dtype=np.int32)
    c[0:24] = (np.asarray(INSERT_LENGTH_N_BITS, np.int32) << 20) | np.asarray(
        INSERT_LENGTH_OFFSET, np.int32
    )
    c[64:88] = (np.asarray(COPY_LENGTH_N_BITS, np.int32) << 20) | np.asarray(
        COPY_LENGTH_OFFSET, np.int32
    )
    c[96:112] = (np.asarray(DISTANCE_SHORT_CODE_INDEX, np.int32) << 4) | (
        np.asarray(DISTANCE_SHORT_CODE_DELTA, np.int32) + 3
    )
    c[128:154] = (np.asarray(BLOCK_LENGTH_N_BITS, np.int32) << 20) | np.asarray(
        BLOCK_LENGTH_OFFSET, np.int32
    )
    sb = np.asarray(DICT_SIZE_BITS_BY_LENGTH, np.int32)
    off = np.asarray(DICT_OFFSETS_BY_LENGTH, np.int32)
    c[160 : 160 + sb.shape[0]] = sb
    c[192 : 192 + off.shape[0]] = off
    return np.broadcast_to(
        c.reshape(2, 1, 128), (2, SUB, 128)
    ).reshape(2 * SUB, 128).copy()


def _context_lut_chunks() -> np.ndarray:
    from ..decode.engine import _CONTEXT_LUT

    lut = np.asarray(_CONTEXT_LUT, np.int32)
    # the kernel's lut2 computes modes 0/1 closed-form and only gathers
    # chunks 8-15 for modes 2/3 — guard that layout here
    r = np.arange(256)
    assert (lut[0:256] == (r & 63)).all() and (lut[256:512] == 0).all()
    assert (lut[512:768] == (r >> 2)).all() and (lut[768:1024] == 0).all()
    return _replicate(lut, 16)


def _dict_chunks() -> tuple[np.ndarray, int]:
    """122 KB static dictionary as (k*8,128) i32 word chunks."""
    global _DICT_WORDS
    if _DICT_WORDS is None:
        from ..decode.dictionary import get_dictionary

        raw = get_dictionary()
        pad = (-len(raw)) % 4
        words = np.frombuffer(raw + b"\x00" * pad, dtype="<u4").view(np.int32)
        k = -(-words.shape[0] // 128)
        _DICT_WORDS = (_replicate(words, k), k)
    return _DICT_WORDS


def _transform_tables() -> tuple[np.ndarray, np.ndarray, int]:
    """(tf_meta 2 chunks, tf_storage chunks, n_storage_chunks).

    meta[2*t]   = (pre_off<<9) | (pre_len<<5) | op
    meta[2*t+1] = (suf_off<<4) | suf_len"""
    from ..decode.transforms import TRANSFORM_LIST

    storage = bytearray()
    meta = np.zeros(256, np.int64)
    for t, (pre, op, suf) in enumerate(TRANSFORM_LIST):
        pre_off = len(storage)
        storage.extend(pre)
        suf_off = len(storage)
        storage.extend(suf)
        assert pre_off < 2048 and suf_off < 4096
        assert len(pre) < 16 and len(suf) < 16 and op < 32
        meta[2 * t] = (pre_off << 9) | (len(pre) << 5) | op
        meta[2 * t + 1] = (suf_off << 4) | len(suf)
    pad = (-len(storage)) % 4
    words = np.frombuffer(
        bytes(storage) + b"\x00" * pad, dtype="<u4"
    ).view(np.int32)
    k = -(-words.shape[0] // 128)
    return _replicate(meta, 2), _replicate(words, k), k


# ---------------------------------------------------------------------------
# host preflight
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupCfg:
    """Per-group static kernel configuration (baked at trace time)."""

    NL: int
    NC: int
    ND: int
    NBT0: int
    NBT1: int
    NBT2: int
    npostfix: int
    ndirect: int
    maxbw: int
    trivial_lit: bool


@dataclass
class V3Batch:
    wt: np.ndarray
    lit_t: np.ndarray
    cmd_t: np.ndarray
    dist_t: np.ndarray
    bsw_t: np.ndarray
    cmap_t: np.ndarray
    dx_t: np.ndarray
    scal: np.ndarray          # (G*5*8,128): start_bit, mlen, blen0/1/2
    mlens: np.ndarray
    n_streams: int
    configs: tuple            # tuple[GroupCfg]
    Wpad: int
    groups: int
    perm: np.ndarray | None = None
    # per-slot real (non-padding) word count; lanes that consume past it
    # ran off their own truncated stream (see decode_batch_v3)
    n_words: np.ndarray | None = None
    # history prefix: per-slot prior-output bytes (None/empty = fresh
    # stream); HR = prefix rows in the output buffer (0 = no prefix)
    HR: int = 0
    hist: list | None = None


@dataclass
class _PreV3:
    words: np.ndarray
    cmd_start_bit: int
    mlen: int
    maxbw: int
    st: object
    sig: bytes


def preflight_one_v3(data: bytes) -> _PreV3 | None:
    """Parse one stream's prologue + full metablock tables (any entropy
    layout); None when the stream shape is device-ineligible (multi
    metablock / uncompressed / metadata / empty / too many trees)."""
    from ..decode.bitreader import BitReader, BrotliError
    from ..decode.engine import (
        _MetablockState,
        _decode_window_bits,
        _read_metablock_length,
    )

    try:
        br = BitReader(bytes(data))
        wbits, _ = _decode_window_bits(br, large_window_enabled=False)
        input_end = bool(br.read(1))
        if input_end and br.read(1):
            return None
        mlen, is_unc, is_meta = _read_metablock_length(br, input_end)
        if is_meta or is_unc or mlen == 0 or not input_end:
            return None
        st = _MetablockState(br, large_window=False)
    except BrotliError:
        return None
    # static kernel caps (VMEM + per-symbol select-chain cost): up to 8
    # block types per category, 16 literal trees, 8 command/distance trees.
    # alice29-class streams ([2,2,5] types, 6/2/6 trees) fit; enc-ttf-class
    # (61 literal block types, 80 trees) decodes on the host.
    if (max(st.num_types) > 8 or len(st.lit_group) > 16
            or len(st.cmd_group) > 8 or len(st.dist_group) > 8):
        return None
    pad = (-len(data)) % 4 + 12
    words = np.frombuffer(bytes(data) + b"\x00" * pad, dtype="<u4")
    return _PreV3(
        words=words, cmd_start_bit=br.bitpos, mlen=mlen,
        maxbw=(1 << wbits) - 16, st=st, sig=_sig_of(st),
    )


def _sig_of(st) -> bytes:
    """Complete table signature of a metablock's entropy state (streams
    with equal signatures share one kernel group's VMEM tables)."""
    sig_parts = [
        bytes([st.npostfix]), st.ndirect.to_bytes(2, "little"),
        np.asarray(st.num_types, np.int64).tobytes(),
        np.asarray(st.context_modes, np.int64).tobytes(),
        np.asarray(st.cmap, np.int64).tobytes(),
        np.asarray(st.dist_cmap, np.int64).tobytes(),
        np.asarray(st.block_len, np.int64).tobytes(),
    ]
    for grp in (st.lit_group, st.cmd_group, st.dist_group):
        for t in grp:
            sig_parts.append(np.asarray(t, np.int64).tobytes())
    for c in range(3):
        for tab in (st.type_tables[c], st.len_tables[c]):
            sig_parts.append(
                b"-" if tab is None else np.asarray(tab, np.int64).tobytes()
            )
    return b"".join(sig_parts)


@dataclass
class _EntryV3:
    """One (stream, metablock) unit of device work: the metablock's
    entropy state plus the continuation context (prior output = history,
    distance ring, last two bytes) the kernel resumes from."""

    idx: int                  # caller's stream index
    st: object                # _MetablockState (tables for THIS metablock)
    words: np.ndarray         # whole stream as u32 words (padded)
    bitpos: int               # absolute bit where commands start
    mlen: int
    maxbw: int
    sig: bytes
    pos0: int = 0             # total output bytes before this metablock
    p1: int = 0
    p2: int = 0
    rings: tuple = (4, 11, 15, 16)
    hist: bytes = b""


def assemble_v3(entries: list, max_groups: int = 4,
                D: int = 64) -> V3Batch | None:
    """Bin device-work entries by (table signature, window) into kernel
    groups; None when over the group budget."""
    if not entries:
        return None
    bins: dict[bytes, list[int]] = {}
    for i, e in enumerate(entries):
        key = e.sig + e.maxbw.to_bytes(4, "little")
        bins.setdefault(key, []).append(i)
    n_groups = sum(-(-len(v) // NSTREAM) for v in bins.values())
    if n_groups > max_groups:
        return None

    G = n_groups
    configs = []
    lit_parts, cmd_parts, dist_parts = [], [], []
    bsw_parts, cmap_parts, dx_parts = [], [], []
    start_bits = np.zeros(G * NSTREAM, np.int32)
    mlens = np.zeros(G * NSTREAM, np.int64)
    n_words = np.zeros(G * NSTREAM, np.int32)
    blen_init = np.zeros((3, G * NSTREAM), np.int32)
    extras = np.zeros((7, G * NSTREAM), np.int32)   # pos0,p1,p2,r0..r3
    extras[3] = 4
    extras[4] = 11
    extras[5] = 15
    extras[6] = 16
    hists: list[bytes] = [b""] * (G * NSTREAM)
    perm = np.full(G * NSTREAM, -1, np.int64)
    rebased = []
    slot_base = 0
    for key, idxs in bins.items():
        idxs.sort(key=lambda i: entries[i].mlen
                  / max(1, 4 * entries[i].words.shape[0]))
        rep = entries[idxs[0]].st
        maxbw = entries[idxs[0]].maxbw
        for off in range(0, len(idxs), NSTREAM):
            part = idxs[off : off + NSTREAM]
            configs.append(GroupCfg(
                NL=len(rep.lit_group), NC=len(rep.cmd_group),
                ND=len(rep.dist_group),
                NBT0=rep.num_types[0], NBT1=rep.num_types[1],
                NBT2=rep.num_types[2],
                npostfix=rep.npostfix, ndirect=rep.ndirect, maxbw=maxbw,
                trivial_lit=bool(rep.trivial_literal),
            ))
            lit_parts.append(np.concatenate(
                [_pad_table(t, LCH) for t in rep.lit_group]
            ))
            cmd_parts.append(np.concatenate(
                [_pad_table(t, CCH) for t in rep.cmd_group]
            ))
            dist_parts.append(np.concatenate(
                [_pad_table(t, DCH) for t in rep.dist_group]
            ))
            bsw = [_pad_table(rep.type_tables[c] or [], BTCH) for c in range(3)]
            bsw += [_pad_table(rep.len_tables[c] or [], BLCH) for c in range(3)]
            bsw_parts.append(np.concatenate(bsw))
            lcm = _lcmch(rep.num_types[0])
            dcm = _dcmch(rep.num_types[2])
            cm = np.zeros((lcm + dcm + 1) * 128, np.int64)
            cm[: len(rep.cmap)] = rep.cmap
            cm[lcm * 128 : lcm * 128 + len(rep.dist_cmap)] = rep.dist_cmap
            for bt, mode in enumerate(rep.context_modes):
                cm[(lcm + dcm) * 128 + bt] = mode << 9
            cmap_parts.append(_pad_table(cm, lcm + dcm + 1))
            dxv = (np.asarray(rep.dist_extra[: 5 * 128], np.int64) << 26) | (
                np.asarray(rep.dist_offset[: 5 * 128], np.int64)
            )
            dx_parts.append(_pad_table(dxv, 5))
            for j, i in enumerate(part):
                e = entries[i]
                slot = slot_base + j
                w0 = e.bitpos >> 5
                rebased.append((slot, e.words[w0:]))
                start_bits[slot] = e.bitpos & 31
                mlens[slot] = e.mlen
                n_words[slot] = e.words.shape[0] - w0
                ebl = e.st.block_len
                for c in range(3):
                    blen_init[c, slot] = min(ebl[c], 1 << 28)
                extras[0, slot] = min(e.pos0, 1 << 30)
                extras[1, slot] = e.p1
                extras[2, slot] = e.p2
                for c in range(4):
                    extras[3 + c, slot] = e.rings[c]
                hists[slot] = e.hist
                perm[slot] = e.idx
            slot_base += NSTREAM

    max_words = max(r.shape[0] for _, r in rebased)
    Wpad = -(-max_words // D) * D + D
    wt = np.zeros((Wpad, G * SUB, LANES), dtype=np.uint32)
    for slot, r in rebased:
        g, rem = divmod(slot, NSTREAM)
        wt[: r.shape[0], g * SUB + rem // LANES, rem % LANES] = r

    scal = np.zeros((G * SCAL_ROWS * SUB, LANES), np.int32)
    for g in range(G):
        sl = slice(g * NSTREAM, (g + 1) * NSTREAM)
        rows = [start_bits[sl], mlens[sl].astype(np.int32),
                blen_init[0, sl], blen_init[1, sl], blen_init[2, sl]]
        rows += [extras[r, sl] for r in range(7)]
        for r_i, row in enumerate(rows):
            scal[(g * SCAL_ROWS + r_i) * SUB :
                 (g * SCAL_ROWS + r_i + 1) * SUB, :] = (
                row.reshape(SUB, LANES)
            )

    def stack(parts):
        return np.concatenate(
            [_replicate(p, p.shape[0] // 128) for p in parts]
        )

    max_hist = max((len(h) for h in hists), default=0)
    HR = ((max_hist + 3) // 4 + 7) // 8 * 8 if max_hist else 0

    return V3Batch(
        wt=wt,
        lit_t=stack(lit_parts), cmd_t=stack(cmd_parts),
        dist_t=stack(dist_parts), bsw_t=stack(bsw_parts),
        cmap_t=stack(cmap_parts), dx_t=stack(dx_parts),
        scal=scal, mlens=mlens, n_streams=len(entries),
        configs=tuple(configs), Wpad=Wpad, groups=G, perm=perm,
        n_words=n_words, HR=HR, hist=hists if HR else None,
    )


def preflight_v3(streams: list[bytes], max_groups: int = 4,
                 D: int = 64) -> V3Batch | None:
    """Bin full-format single-metablock streams by complete table
    signature into kernel groups; None when ineligible (no streams, a
    device-ineligible stream shape, or too many groups)."""
    if not streams:
        return None
    entries = []
    for i, s in enumerate(streams):
        p = preflight_one_v3(s)
        if p is None:
            return None
        entries.append(_EntryV3(
            idx=i, st=p.st, words=p.words, bitpos=p.cmd_start_bit,
            mlen=p.mlen, maxbw=p.maxbw, sig=p.sig,
        ))
    batch = assemble_v3(entries, max_groups=max_groups, D=D)
    if batch is not None:
        batch.n_streams = len(streams)
    return batch


def _compound_flat(custom_dictionary) -> bytes:
    """Compound chunks as one linear buffer (host copies across chunk
    seams byte-linearly, so concatenation is equivalent)."""
    if not custom_dictionary:
        return b""
    if isinstance(custom_dictionary, (bytes, bytearray, memoryview)):
        return bytes(custom_dictionary)
    return b"".join(bytes(c) for c in custom_dictionary)


# caps for the full path (VMEM + per-symbol select-chain budget at G=1);
# enc-ttf (80 lit trees / 61 types) and noto-tc mb1 (142 trees / 72 types)
# fit.  Reference handles 256 types (engine.ts:679-726) - streams beyond
# these caps host-fallback.
_FULL_NL = 160
_FULL_NC = 32
_FULL_ND = 32
_FULL_NBT = 128


def _caps_full_ok(st) -> bool:
    return (max(st.num_types) <= _FULL_NBT
            and len(st.lit_group) <= _FULL_NL
            and len(st.cmd_group) <= _FULL_NC
            and len(st.dist_group) <= _FULL_ND)
