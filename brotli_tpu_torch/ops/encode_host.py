"""Host steps of the device encoder: table clustering, Huffman codes,
stream headers and block-switch plans, all numpy (and the native
Huffman and context-map builders through ctypes).

A copy of the host half of brotli_tpu/ops/device_encode.py, so that the
port imports nothing of the JAX package:

* lines 54-62 -- batch and cell sizes, the hash multiplier, record kinds;
* lines 582-590 -- `PACK_BR` and `_tab_chunks`;
* lines 918-940 -- `_pack_consts`, `DIST_ALPHABET`, `_HIST_STRIDE_DEFAULT`
  and `_hg`;
* lines 985-1311 -- `_split_group_hist`, `_cluster_rows`,
  `_group_tables_from_hists`, `_cluster_lanes`, `_plan_block_switches`,
  `_header_bits`, `_pack_symbol_table`.

ops/device_encode.py calls them between its device stages.  The tests hold
these copies to the originals table by table.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..constants import (
    COPY_LENGTH_N_BITS,
    INSERT_LENGTH_N_BITS,
    NUM_COMMAND_SYMBOLS,
    NUM_LITERAL_SYMBOLS,
)

B_LANES = 1024        # streams per batch (8 sublanes x 128 lanes downstream)
CHUNK_N = 32768       # bytes per chunk
MATCH_CAP = 8         # carried-window match cap before extension
MAX_LEN = 512         # copy-length cap (longer runs split; trims doubling passes)
CELL = 64             # greedy-parse cell size
HASH_MUL = 0x1E35A7BD

# record kinds
K_PAD, K_CMD, K_LIT, K_DIST = 0, 1, 2, 3


PACK_BR = 256        # records per grid step


def _tab_chunks(nt: int) -> int:
    """Combined per-group symbol table chunks: nt*256 literal entries
    (context trees) + 704 cmd + 64 dist = 256*(nt+3) -> 2*nt+6 chunks."""
    return 2 * nt + 6


def _pack_consts() -> np.ndarray:
    c = np.zeros(128, dtype=np.int32)
    c[0:24] = np.asarray(INSERT_LENGTH_N_BITS, np.int32)
    c[64:88] = np.asarray(COPY_LENGTH_N_BITS, np.int32)
    return np.broadcast_to(c[None, :], (8, 128)).copy()


# ---------------------------------------------------------------------------
# stage 7 + 9: host-side tables, headers, orchestration, assembly
# ---------------------------------------------------------------------------

DIST_ALPHABET = 16 + 0 + (48 << 0)  # npostfix=0, ndirect=0


# flat per-group histogram layout for the device bincount:
# [64*256 lit(ctx,byte) | 704 cmd | 64 dist] = 17152 bins per group + 1 dump
_HIST_STRIDE_DEFAULT = 8


def _hg(nbt: int) -> int:
    """Flat per-group bins: nbt*64 (type,ctx) x 256 lit + 704 cmd + 64 dist."""
    return nbt * 64 * 256 + NUM_COMMAND_SYMBOLS + 64


def _split_group_hist(flat: np.ndarray, g: int, nbt: int = 1):
    """(lit_hists (nbt*64,256), cmd_hist, dist_hist) for group g."""
    hg = _hg(nbt)
    lit_bins = nbt * 64 * 256
    seg = flat[g * hg : (g + 1) * hg].astype(np.int64)
    lit_hists = seg[:lit_bins].reshape(nbt * 64, 256)
    cmd_hist = seg[lit_bins : lit_bins + 704] * 8 + 1
    dist_hist = seg[lit_bins + 704 : lit_bins + 704 + 64] * 8 + 1
    return lit_hists, cmd_hist, dist_hist


def _cluster_rows(hists: np.ndarray, k: int, iters: int = 8):
    """Weighted k-means over normalized histogram rows; returns map (rows,)
    into [0, k') with k' <= k, renumbered densely."""
    n = hists.shape[0]
    w = hists.sum(axis=1)
    feats = hists / np.maximum(w, 1)[:, None]
    order = np.argsort(-w)
    centers = feats[order[:: max(1, n // k)]][:k].copy()
    g = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
        g = d.argmin(axis=1)
        for j in range(centers.shape[0]):
            sel = g == j
            if sel.any() and w[sel].sum() > 0:
                centers[j] = (
                    (feats[sel] * w[sel][:, None]).sum(axis=0)
                    / max(w[sel].sum(), 1)
                )
    used = sorted(set(g.tolist()))
    remap = {j: i for i, j in enumerate(used)}
    return np.asarray([remap[int(x)] for x in g], np.int64)


def _group_tables_from_hists(lit_hists, cmd_hist, dist_hist, nt: int):
    """One table group's entropy codes: (lit_tables [<=nt], cmap (64,),
    cmd, dist).  Literal contexts (UTF8 mode) cluster into <= nt trees
    via the reference's exact bit-cost agglomerative clustering
    (cluster.ts:317-378, reused from the host encoder) — measured ~2pt
    better ratio than L2 k-means on font content."""
    # native (C++) table build when available: bit-identical to the python
    # implementations (tests/test_native_tables.py), ~150x faster - the
    # per-batch host table step otherwise caps encode throughput
    try:
        from ..native import (
            build_huffman_code_native as build_huffman_code,
            cluster_context_map_native,
        )

        def _cluster_ctx(hists_list, rows, syms):
            return cluster_context_map_native(hists_list, rows, syms)
    except Exception:  # pragma: no cover - toolchain-less hosts
        from ..encode.entropy import build_huffman_code
        from ..encode.metablock_full import (
            _cluster_and_build_context_map as _cluster_ctx,
        )

    n_rows = lit_hists.shape[0]   # 64 contexts, x NBT block types if split
    if nt == 1:
        cmap = np.zeros(n_rows, np.int64)
        tree_hists = lit_hists.sum(axis=0, keepdims=True)
    else:
        n_used, cm = _cluster_ctx(
            lit_hists.tolist(), n_rows, NUM_LITERAL_SYMBOLS
        )
        cmap = np.asarray(cm, np.int64)
        if n_used > nt:
            # cap at the kernel's tree budget: fold the smallest-weight
            # clusters into their nearest (bit-cost) survivor
            w = np.zeros(n_used, np.int64)
            for c in range(n_rows):
                w[cmap[c]] += int(lit_hists[c].sum())
            keep = np.argsort(-w)[:nt]
            keep_set = set(keep.tolist())
            remap = {}
            for j in range(n_used):
                if j in keep_set:
                    remap[j] = j
            hs = {j: lit_hists[cmap == j].sum(axis=0) for j in range(n_used)}

            def cost(h):
                t = h.sum()
                nz = h[h > 0]
                return float(t * np.log2(max(t, 1)) - (nz * np.log2(nz)).sum()) \
                    if t > 0 else 0.0

            for j in range(n_used):
                if j in keep_set:
                    continue
                best, bestd = None, None
                for k in keep:
                    d = cost(hs[j] + hs[int(k)]) - cost(hs[int(k)])
                    if bestd is None or d < bestd:
                        best, bestd = int(k), d
                remap[j] = best
            cmap = np.asarray([remap[int(x)] for x in cmap], np.int64)
            used = sorted(set(cmap.tolist()))
            dense = {j: i for i, j in enumerate(used)}
            cmap = np.asarray([dense[int(x)] for x in cmap], np.int64)
        n_used = int(cmap.max()) + 1
        tree_hists = np.zeros((n_used, 256), np.int64)
        for c in range(n_rows):
            tree_hists[cmap[c]] += lit_hists[c]
    lits = [
        build_huffman_code(h * 8 + 1, NUM_LITERAL_SYMBOLS) for h in tree_hists
    ]
    return dict(
        lits=lits, cmap=cmap,
        cmd=build_huffman_code(cmd_hist, NUM_COMMAND_SYMBOLS),
        dist=build_huffman_code(dist_hist, DIST_ALPHABET),
    )


def _cluster_lanes(rec0_sample: np.ndarray, n_groups: int,
                   n_chunks: int) -> np.ndarray:
    """Cluster lanes by literal-histogram shape into <= n_groups table
    groups (group id per lane).

    The analog of the reference's per-metablock histogram clustering
    (cluster.ts:317-378) at batch granularity: mixed batches (text + font)
    stop paying for one compromise table set.  Plain numpy k-means on
    32-bin projected literal histograms from the coarse record sample —
    the host cost is microscopic next to the device stages.
    """
    B = rec0_sample.shape[0]
    group = np.zeros(B, np.int64)
    kinds = (rec0_sample >> 28) & 0xF
    feats = np.zeros((B, 32), np.int64)
    for lane in range(min(B, n_chunks)):
        lc = rec0_sample[lane][kinds[lane] == K_LIT] & 0xFF
        np.add.at(feats[lane], lc >> 3, 1)
    if n_groups > 1:
        group[:n_chunks] = _cluster_rows(feats[:n_chunks], n_groups)
    # per-group literal context mode: binary-looking groups (frequent
    # high bytes) use the SIGNED context, text the UTF8 context — the
    # device analog of the reference's chooseContextMode (context.ts:179)
    n_used = int(group[:n_chunks].max()) + 1
    modes = []
    for j in range(n_used):
        sel = group[:n_chunks] == j
        f = feats[:n_chunks][sel].sum(axis=0)
        total = max(int(f.sum()), 1)
        modes.append(3 if int(f[16:].sum()) / total > 0.25 else 2)
    return group, modes


def _cluster_lanes_feats(feats: np.ndarray, n_groups: int, n_chunks: int):
    """_cluster_lanes from the lanes' (n_chunks, 32) int64 literal counts
    (ops/device_encode.lane_features counts them on the device): the same
    k-means on the same integers, so the same (group (B_LANES,), modes)."""
    group = np.zeros(B_LANES, np.int64)
    if n_groups > 1:
        group[:n_chunks] = _cluster_rows(feats[:n_chunks], n_groups)
    n_used = int(group[:n_chunks].max()) + 1
    modes = []
    for j in range(n_used):
        f = feats[:n_chunks][group[:n_chunks] == j].sum(axis=0)
        total = max(int(f.sum()), 1)
        modes.append(3 if int(f[16:].sum()) / total > 0.25 else 2)
    return group, modes


def _fold_costs(hists: np.ndarray) -> np.ndarray:
    """_group_tables_from_hists' `cost` of each row of `hists` (rows, 256)
    int64, the same doubles: each row's t * log2(max(t, 1)) less the
    pairwise `.sum()` of its nonzero counts' n * log2(n), taken from one
    log2 over every row's nonzero counts (numpy's log2 is elementwise);
    0.0 for an empty row."""
    t = hists.sum(axis=1)
    mask = hists > 0
    nz = hists[mask]
    vals = nz * np.log2(nz)
    ends = np.cumsum(mask.sum(axis=1))
    starts = np.concatenate([[0], ends[:-1]])
    sums = np.asarray([vals[a:b].sum() for a, b in zip(starts.tolist(),
                                                       ends.tolist())])
    return np.where(t > 0, t * np.log2(np.maximum(t, 1)) - sums, 0.0)


def _group_tables_once(lit_hists, cmd_hist, dist_hist, nt: int,
                       clustered):
    """_group_tables_from_hists with no step repeated: the clusters'
    weights and sums are one np.add.at each, and the fold computes each
    kept cluster's cost once (not once a candidate) and a folded cluster's
    costs against all the kept ones at once (_fold_costs).  The fold's
    doubles are the same, so its argmin (the first minimum, as the loop's
    strict `<` takes), and the tables, are the same.  `clustered` is the
    native clustering's (count, map) of these literal histograms, made
    already (cluster_groups_native); None with one tree."""
    from ..native import build_huffman_code_native as build_huffman_code

    n_rows = lit_hists.shape[0]
    if nt == 1:
        cmap = np.zeros(n_rows, np.int64)
        tree_hists = lit_hists.sum(axis=0, keepdims=True)
    else:
        n_used, cm = clustered
        cmap = np.asarray(cm, np.int64)
        if n_used > nt:
            w = np.zeros(n_used, np.int64)
            np.add.at(w, cmap, lit_hists.sum(axis=1))
            keep = np.argsort(-w)[:nt]
            keep_set = set(keep.tolist())
            hs = np.zeros((n_used, lit_hists.shape[1]), np.int64)
            np.add.at(hs, cmap, lit_hists)
            hk = hs[keep]
            kept_cost = _fold_costs(hk)
            remap = np.arange(n_used)
            for j in range(n_used):
                if j not in keep_set:
                    d = _fold_costs(hs[j][None, :] + hk) - kept_cost
                    remap[j] = keep[int(np.argmin(d))]   # the first minimum
            cmap = np.unique(remap[cmap], return_inverse=True)[1] \
                .reshape(-1).astype(np.int64)
        n_used = int(cmap.max()) + 1
        tree_hists = np.zeros((n_used, 256), np.int64)
        np.add.at(tree_hists, cmap, lit_hists)
    lits = [
        build_huffman_code(h * 8 + 1, NUM_LITERAL_SYMBOLS) for h in tree_hists
    ]
    return dict(
        lits=lits, cmap=cmap,
        cmd=build_huffman_code(cmd_hist, NUM_COMMAND_SYMBOLS),
        dist=build_huffman_code(dist_hist, DIST_ALPHABET),
    )


_ENC_LIB: ctypes.CDLL | None = None


def _enc_lib() -> ctypes.CDLL:
    """native/enc_header.cpp, built into brotli_tpu_torch/build/ at first
    use (build._build, gated on a hash of it and of table_builder.cpp,
    which it includes); a failed build raises."""
    global _ENC_LIB
    if _ENC_LIB is None:
        from ..build import _build

        native = Path(__file__).resolve().parent.parent / "native"
        path = _build(
            "brotli_tpu_torch_enc_header",
            ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17"],
            ["g++", "-shared"], [native / "enc_header.cpp"],
            deps=[native / "table_builder.cpp"])
        lib = ctypes.CDLL(str(path))
        P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        fn = lib.brotli_enc_header
        fn.restype = I64
        fn.argtypes = ([I32, I32, I32, P, P, I32, P, I32, I32, P, P, I32, I32,
                        P, P, P, I64])
        cg = lib.brotli_enc_cluster_groups
        cg.restype = None
        cg.argtypes = [P, I32, I32, I32, I32, P, P, I32]
        _ENC_LIB = lib
    return _ENC_LIB


def cluster_groups_native(lit_hists: np.ndarray, n_threads: int) -> list:
    """native_cluster_context_map (the native clustering of
    _group_tables_from_hists) of each group's literal histograms
    (groups, rows, 256) int64, the groups over `n_threads` C++ threads in
    one call: [(cluster count, map (rows,) int64)] a group."""
    g, rows, syms = lit_hists.shape
    hists = np.ascontiguousarray(lit_hists, np.int64)
    cmaps = np.zeros((g, rows), np.int32)
    counts = np.zeros(g, np.int32)
    if rows <= 1:
        return [(1, np.zeros(max(1, rows), np.int64)) for _ in range(g)]
    _enc_lib().brotli_enc_cluster_groups(
        hists.ctypes.data, g, rows, syms, 64, cmaps.ctypes.data,
        counts.ctypes.data, n_threads)
    return [(int(counts[j]), cmaps[j].astype(np.int64)) for j in range(g)]


_BLEN = None


def _header_words_native(mlen: int, lgwin: int, grp_tables: dict,
                         split: dict | None = None):
    """One header, built once through native/enc_header.cpp (the C++ form
    of _header_bits: the same bits): (its whole 32-bit words as uint32,
    the bits of its last partial word, their count)."""
    global _BLEN
    if _BLEN is None:
        from ..constants import BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET

        _BLEN = [np.ascontiguousarray(np.asarray(x, np.int32))
                 for x in (BLOCK_LENGTH_OFFSET, BLOCK_LENGTH_N_BITS)]
    lits = grp_tables["lits"]
    nt = len(lits)
    trees = [*lits, grp_tables["cmd"], grp_tables["dist"]]
    depths = np.concatenate([np.asarray(t[0], np.uint8) for t in trees])
    meta = np.asarray([[t[2], *t[3]] for t in trees], np.int32)
    nbt = split["nbt"] if split else 1
    cmap = np.ascontiguousarray(np.asarray(grp_tables["cmap"], np.int32))
    hists = [np.zeros(1, np.int64)] * 2
    first_blen = t0 = 0
    if nbt > 1:
        hists = [np.ascontiguousarray(np.asarray(split[k], np.int64))
                 for k in ("thist", "lhist")]
        first_blen, t0 = int(split["first_blen"]), int(split["t0"])
    out = np.empty(1 << 16, np.uint8)
    bits = _enc_lib().brotli_enc_header(
        mlen, lgwin, nt, depths.ctypes.data, meta.ctypes.data, DIST_ALPHABET,
        cmap.ctypes.data, grp_tables.get("mode", 0), nbt,
        hists[0].ctypes.data, hists[1].ctypes.data, first_blen, t0,
        _BLEN[0].ctypes.data, _BLEN[1].ctypes.data, out.ctypes.data,
        out.size)
    if bits < 0:
        raise RuntimeError("a stream header longer than 64 KB")
    n = -(-bits // 32)
    words = np.zeros(n, np.uint32)
    words.view(np.uint8)[: (bits + 7) // 8] = out[: (bits + 7) // 8]
    rem = bits % 32
    partial = int(words[bits // 32]) & ((1 << rem) - 1) if rem else 0
    return words[: bits // 32], partial, rem


def _plan_block_switches(seg_type: np.ndarray, seg_litcnt: np.ndarray,
                         n_chunks: int, group_of: np.ndarray,
                         n_groups: int, nbt: int):
    """Turn per-segment types into concrete block-switch plans (host).

    Vectorized over lanes, looping only over the <=32 segments: merge
    same-type neighbour segments, cap block length at 16624 literals (the
    largest 13-extra-bit block count — keeps every in-stream switch within
    the 27-bit record budget), compute forward block lengths, and build
    per-GROUP type/length prefix trees.  Block type ids are permuted per
    lane (swap 0 <-> lane's first type) because RFC 7932 fixes the first
    block's type at 0 (block-splitter.ts analog: splits there always start
    at type 0); the header's context map is permuted the same way so the
    kernel keeps using global ids.

    Returns (sw_words (B, NSEG) u32 = bit pattern | nbits<<27,
    first_blen (B,), t0 (B,), group_splits[g] dict).
    """
    from ..constants import BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET
    from ..encode.bitwriter import BitWriter
    from ..encode.entropy import build_and_store_huffman_tree

    B, NSEG = seg_type.shape
    MAX_BLEN = int(BLOCK_LENGTH_OFFSET[25]) - 1   # 16624
    cnts = seg_litcnt.astype(np.int64)
    mark = np.zeros((B, NSEG), bool)
    mark[:, 0] = True
    cur = seg_type[:, 0].copy()
    run = cnts[:, 0].copy()
    for s in range(1, NSEG):
        c = cnts[:, s]
        sw = (c > 0) & ((seg_type[:, s] != cur) | (run + c > MAX_BLEN))
        mark[:, s] = sw
        cur = np.where(sw, seg_type[:, s], cur)
        run = np.where(sw, 0, run) + c
    blen = np.zeros((B, NSEG), np.int64)
    acc = np.zeros(B, np.int64)
    for s in range(NSEG - 1, -1, -1):
        acc = acc + cnts[:, s]
        blen[:, s] = np.where(mark[:, s], acc, 0)
        acc = np.where(mark[:, s], 0, acc)

    t0 = seg_type[:, 0].copy()
    ptype = np.where(seg_type == t0[:, None], 0,
                     np.where(seg_type == 0, t0[:, None], seg_type))
    tsym = ptype + 2     # always-explicit type codes (valid, simple)
    lcode = np.clip(
        np.searchsorted(BLOCK_LENGTH_OFFSET, blen, side="right") - 1, 0, 25
    )
    extra = blen - BLOCK_LENGTH_OFFSET[lcode]
    nb_extra = BLOCK_LENGTH_N_BITS[lcode]

    in_batch = np.zeros(B, bool)
    in_batch[:n_chunks] = True
    body_mark = mark.copy()
    body_mark[:, 0] = False   # block 0 is declared in the header
    sw_words = np.zeros((B, NSEG), np.uint32)
    group_splits = []
    for g in range(n_groups):
        lanes = in_batch & (group_of[:B] == g)
        bm = body_mark & lanes[:, None]
        am = mark & lanes[:, None]
        thist = np.bincount(tsym[bm], minlength=nbt + 2).tolist()
        lhist = np.bincount(lcode[am], minlength=26).tolist()
        if sum(thist) == 0:
            thist[2] = 1  # no switches in group: still store a valid tree
        if sum(lhist) == 0:
            lhist[0] = 1

        def trees(th, lh):
            wtmp = BitWriter()
            td, tb = build_and_store_huffman_tree(wtmp, th, nbt + 2)
            ld, lb = build_and_store_huffman_tree(wtmp, lh, 26)
            return td, tb, ld, lb

        td, tb, ld, lb = trees(thist, lhist)
        tdn, tbn = np.asarray(td), np.asarray(tb)
        ldn, lbn = np.asarray(ld), np.asarray(lb)
        nbits = tdn[np.clip(tsym, 0, nbt + 1)] + ldn[lcode] + nb_extra
        if bm.any() and int(nbits[bm].max()) > 27:
            # pathological tree depths: rebuild from flat histograms so
            # every used symbol gets a ~log2(n) code (<= 27 total bits)
            thist = [1 if c else 0 for c in thist]
            lhist = [1 if c else 0 for c in lhist]
            td, tb, ld, lb = trees(thist, lhist)
            tdn, tbn = np.asarray(td), np.asarray(tb)
            ldn, lbn = np.asarray(ld), np.asarray(lb)
            nbits = tdn[np.clip(tsym, 0, nbt + 1)] + ldn[lcode] + nb_extra
            assert int(nbits[bm].max()) <= 27
        tsymc = np.clip(tsym, 0, nbt + 1)
        pat = (
            tbn[tsymc].astype(np.int64)
            | (lbn[lcode].astype(np.int64) << tdn[tsymc].astype(np.int64))
            | (extra << (tdn[tsymc] + ldn[lcode]).astype(np.int64))
        )
        w_g = (pat & 0x7FFFFFF) | (nbits.astype(np.int64) << 27)
        sw_words = np.where(bm, w_g.astype(np.uint32), sw_words)
        group_splits.append(dict(thist=thist, lhist=lhist))
    first_blen = blen[:, 0]
    return sw_words, first_blen, t0, group_splits


def _header_bits(mlen: int, lgwin: int, grp_tables: dict,
                 split: dict | None = None) -> "object":
    """Stream + metablock header + tree declarations for one chunk.

    Single block type per category (or NBT literal block types when
    `split` is given: type + length trees and the first block length per
    metablock_full._build_and_store_block_split_code's layout); NT
    context-mapped literal trees when the group has them.  Returns the
    BitWriter."""
    from ..constants import BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET
    from ..encode.bitwriter import BitWriter, encode_window_bits, store_var_len_uint8
    from ..encode.context_map import encode_context_map
    from ..encode.entropy import build_and_store_huffman_tree, store_huffman_tree
    from ..encode.metablock import store_compressed_metablock_header

    lits = grp_tables["lits"]
    nt = len(lits)
    nbt = split["nbt"] if split else 1
    w = BitWriter()
    nb, val = encode_window_bits(lgwin, False)
    w.write(nb, val)
    store_compressed_metablock_header(w, True, mlen)
    if nbt > 1:
        store_var_len_uint8(w, nbt - 1)      # NBLTYPESL - 1
        _, _ = build_and_store_huffman_tree(w, split["thist"], nbt + 2)
        ld, lb = build_and_store_huffman_tree(w, split["lhist"], 26)
        # first block switch: length only (type is implicitly 0)
        fb = int(split["first_blen"])
        code = int(np.searchsorted(BLOCK_LENGTH_OFFSET, fb, side="right")) - 1
        w.write(ld[code], lb[code])
        w.write(int(BLOCK_LENGTH_N_BITS[code]),
                fb - int(BLOCK_LENGTH_OFFSET[code]))
    else:
        store_var_len_uint8(w, 0)  # NBLTYPESL - 1
    store_var_len_uint8(w, 0)  # NBLTYPESI - 1
    store_var_len_uint8(w, 0)  # NBLTYPESD - 1
    w.write(2, 0)              # NPOSTFIX
    w.write(4, 0)              # NDIRECT >> NPOSTFIX
    # context mode: per-group choice (UTF8/SIGNED) when context-mapped
    mode = grp_tables.get("mode", 0) if nt > 1 else 0
    for _ in range(nbt):
        w.write(2, mode)
    cmap = list(grp_tables["cmap"])
    if nbt > 1:
        # permute type rows 0 <-> t0 (first block must be type 0; the
        # in-stream switch symbols use the same permutation)
        t0 = int(split["t0"])
        rows = list(range(nbt))
        rows[0], rows[t0] = rows[t0], rows[0]
        cmap = [cmap[r * 64 + c] for r in rows for c in range(64)]
    encode_context_map(w, cmap, nt)
    encode_context_map(w, [0, 0, 0, 0], 1)   # trivial distance cmap
    for lit in lits:
        store_huffman_tree(w, lit[0], NUM_LITERAL_SYMBOLS, lit[2], lit[3])
    cmd = grp_tables["cmd"]
    dist = grp_tables["dist"]
    store_huffman_tree(w, cmd[0], NUM_COMMAND_SYMBOLS, cmd[2], cmd[3])
    store_huffman_tree(w, dist[0], DIST_ALPHABET, dist[2], dist[3])
    return w


def _pack_symbol_table(grp_tables: dict, nt: int) -> np.ndarray:
    """Combined (nbits<<16|bits) table, row-replicated (TABK*8, 128):
    [nt x 256 literal trees | 704 cmd | 64 dist]."""
    tabk = _tab_chunks(nt)
    flat = np.zeros(tabk * 128, dtype=np.int32)

    def put(off, depths, bits):
        d = np.asarray(depths, np.int32)
        b = np.asarray(bits, np.int32)
        flat[off : off + d.shape[0]] = (d << 16) | b

    for t, lit in enumerate(grp_tables["lits"]):
        put(t * 256, lit[0], lit[1])
    put(nt * 256, grp_tables["cmd"][0], grp_tables["cmd"][1])
    put(nt * 256 + 704, grp_tables["dist"][0], grp_tables["dist"][1])
    chunks = flat.reshape(tabk, 1, 128)
    return np.broadcast_to(chunks, (tabk, 8, 128)).reshape(tabk * 8, 128).copy()
