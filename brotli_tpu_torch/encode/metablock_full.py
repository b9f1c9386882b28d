"""Full metablock path: block splitting + context modeling (metablock.ts:392-761).

Falls back to the trivial path exactly when the reference does
(length < 128, quality < 5, fewer than 6 commands, or a degenerate split).
"""

from __future__ import annotations

from ..constants import NUM_COMMAND_SYMBOLS, NUM_LITERAL_SYMBOLS
from .bitwriter import BitWriter, store_var_len_uint8
from .block_splitter import BlockSplit, split_block
from .cluster import ClusterHistogram, cluster_histograms
from .command import Command, store_command_extra
from .context import (
    NUM_DISTANCE_CONTEXTS,
    NUM_LITERAL_CONTEXTS,
    choose_context_mode,
    get_context,
    get_context_lut,
)
from .context_map import encode_context_map
from .entropy import build_and_store_huffman_tree
from .metablock import (
    get_block_length_code,
    store_compressed_metablock_header,
    store_metablock_trivial,
)

LITERAL_CONTEXT_BITS = 6
DISTANCE_CONTEXT_BITS = 2


class _BlockTypeCodeCalculator:
    def __init__(self):
        self.last_type = 1
        self.second_last_type = 0

    def next_code(self, block_type: int) -> int:
        if block_type == self.last_type + 1:
            code = 1
        elif block_type == self.second_last_type:
            code = 0
        else:
            code = block_type + 2
        self.second_last_type = self.last_type
        self.last_type = block_type
        return code


class _BlockSplitCode:
    __slots__ = ("type_depths", "type_bits", "length_depths", "length_bits", "calc")

    def __init__(self, num_types):
        self.type_depths = [0] * (num_types + 2)
        self.type_bits = [0] * (num_types + 2)
        self.length_depths = [0] * 26
        self.length_bits = [0] * 26
        self.calc = _BlockTypeCodeCalculator()


def _store_block_switch(w, code: _BlockSplitCode, block_len, block_type, is_first):
    type_code = code.calc.next_code(block_type)
    if not is_first:
        w.write(code.type_depths[type_code], code.type_bits[type_code])
    len_code, n_extra, extra = get_block_length_code(block_len)
    w.write(code.length_depths[len_code], code.length_bits[len_code])
    w.write(n_extra, extra)


def _build_and_store_block_split_code(
    w: BitWriter, types, lengths, num_blocks, num_types
) -> _BlockSplitCode:
    code = _BlockSplitCode(num_types)
    type_histo = [0] * (num_types + 2)
    length_histo = [0] * 26
    calc = _BlockTypeCodeCalculator()
    for i in range(num_blocks):
        type_code = calc.next_code(types[i])
        if i != 0:
            type_histo[type_code] += 1
        length_histo[get_block_length_code(lengths[i])[0]] += 1
    store_var_len_uint8(w, num_types - 1)
    if num_types > 1:
        code.type_depths, code.type_bits = build_and_store_huffman_tree(
            w, type_histo, num_types + 2
        )
        code.length_depths, code.length_bits = build_and_store_huffman_tree(
            w, length_histo, 26
        )
        _store_block_switch(w, code, lengths[0], types[0], True)
    return code


class _BlockEncoder:
    def __init__(self, histogram_length, num_types, types, lengths, num_blocks):
        self.histogram_length = histogram_length
        self.num_types = num_types
        self.types = types
        self.lengths = lengths
        self.num_blocks = num_blocks
        self.split_code: _BlockSplitCode | None = None
        self.block_idx = 0
        self.block_len = lengths[0] if num_blocks > 0 else 0
        self.entropy_idx = 0
        self.depths: list[int] = []
        self.bits: list[int] = []

    def build_and_store_entropy_codes(self, w: BitWriter) -> None:
        if self.num_types > 1:
            self.split_code = _build_and_store_block_split_code(
                w, self.types, self.lengths, self.num_blocks, self.num_types
            )
        else:
            store_var_len_uint8(w, 0)

    def build_and_store_huffman_trees(self, w: BitWriter, histograms) -> None:
        self.depths = [0] * (len(histograms) * self.histogram_length)
        self.bits = [0] * (len(histograms) * self.histogram_length)
        for i, h in enumerate(histograms):
            off = i * self.histogram_length
            d, b = build_and_store_huffman_tree(w, h, self.histogram_length)
            self.depths[off : off + self.histogram_length] = d
            self.bits[off : off + self.histogram_length] = b

    def _maybe_switch(self, w, context_bits: int | None) -> None:
        if (
            self.block_len == 0
            and self.split_code is not None
            and self.block_idx + 1 < self.num_blocks
        ):
            self.block_idx += 1
            block_type = self.types[self.block_idx]
            self.block_len = self.lengths[self.block_idx]
            if context_bits is None:
                self.entropy_idx = block_type * self.histogram_length
            else:
                self.entropy_idx = block_type << context_bits
            _store_block_switch(w, self.split_code, self.block_len, block_type, False)

    def store_symbol(self, w: BitWriter, symbol: int) -> None:
        self._maybe_switch(w, None)
        self.block_len -= 1
        ix = self.entropy_idx + symbol
        w.write(self.depths[ix], self.bits[ix])

    def store_symbol_with_context(
        self, w: BitWriter, symbol, context, context_map, context_bits
    ) -> None:
        self._maybe_switch(w, context_bits)
        self.block_len -= 1
        histo_idx = context_map[self.entropy_idx + context]
        ix = histo_idx * self.histogram_length + symbol
        w.write(self.depths[ix], self.bits[ix])


def _cluster_and_build_context_map(histograms, num_histograms, alphabet_size):
    """Returns (num_clusters, context_map) (metablock.ts:763-798)."""
    if num_histograms <= 1:
        return 1, [0] * max(1, num_histograms)
    cluster_in = []
    for h in histograms:
        ch = ClusterHistogram(alphabet_size)
        ch.data[:] = h
        ch.total_count = int(sum(h))
        ch.bit_cost = ch.compute_bit_cost()
        cluster_in.append(ch)
    out = [ClusterHistogram(alphabet_size) for _ in range(num_histograms)]
    context_map = [0] * num_histograms
    cluster_histograms(cluster_in, num_histograms, 64, out, context_map)
    return max(context_map) + 1, context_map


def _build_clustered_histograms(histograms, context_map, num_clusters, alphabet_size):
    result = [[0] * alphabet_size for _ in range(num_clusters)]
    for i, h in enumerate(histograms):
        cluster = context_map[i]
        row = result[cluster]
        for j in range(alphabet_size):
            row[j] += h[j]
    return result


def store_metablock(
    w: BitWriter,
    data,
    start_pos: int,
    length: int,
    mask: int,
    is_last: bool,
    commands: list[Command],
    dist_alphabet_size: int,
    quality: int,
    npostfix: int = 0,
    ndirect: int = 0,
    mode: int = 0,
    context_prelude: tuple[int, int] = (0, 0),
) -> None:
    """`context_prelude` = (p1, p2): the two output bytes preceding this
    metablock.  The decoder's literal-context state carries across metablock
    boundaries (decode side: engine.ts:1218-1219 reads ring[pos-1/-2]), so a
    non-first metablock/fragment must model from the true prior bytes — the
    reference hardcodes 0,0 (metablock.ts:576-577), which desyncs
    context-modeled multi-metablock streams; fixed here."""
    if length < 128 or quality < 5 or len(commands) < 6:
        store_metablock_trivial(
            w, data, start_pos, length, mask, is_last, commands,
            dist_alphabet_size, npostfix, ndirect,
        )
        return

    literal_split = BlockSplit()
    command_split = BlockSplit()
    distance_split = BlockSplit()
    split_block(
        commands, data, start_pos, mask, quality,
        literal_split, command_split, distance_split,
    )
    if (
        literal_split.num_types <= 1
        and command_split.num_types <= 1
        and distance_split.num_types <= 1
    ):
        store_metablock_trivial(
            w, data, start_pos, length, mask, is_last, commands,
            dist_alphabet_size, npostfix, ndirect,
        )
        return

    context_mode = choose_context_mode(data, start_pos, min(length, 4096))
    context_lut = get_context_lut(context_mode)

    num_literal_contexts = literal_split.num_types * NUM_LITERAL_CONTEXTS
    literal_histograms = [[0] * NUM_LITERAL_SYMBOLS for _ in range(num_literal_contexts)]
    command_histograms = [
        [0] * NUM_COMMAND_SYMBOLS for _ in range(command_split.num_types)
    ]
    num_distance_contexts = distance_split.num_types * NUM_DISTANCE_CONTEXTS
    distance_histograms = [
        [0] * dist_alphabet_size for _ in range(num_distance_contexts)
    ]

    # --- histogram fill (walk commands through the block splits) -----------
    pos = start_pos
    lit_idx, lit_len, lit_type, lit_count = 0, 0, 0, 0
    if literal_split.num_blocks > 0:
        lit_len, lit_type = literal_split.lengths[0], literal_split.types[0]
    else:
        lit_len = length
    cmd_idx, cmd_len, cmd_type, cmd_count = 0, 0, 0, 0
    if command_split.num_blocks > 0:
        cmd_len, cmd_type = command_split.lengths[0], command_split.types[0]
    else:
        cmd_len = len(commands)
    dist_idx, dist_len, dist_type, dist_count = 0, 0, 0, 0
    if distance_split.num_blocks > 0:
        dist_len, dist_type = distance_split.lengths[0], distance_split.types[0]
    else:
        dist_len = len(commands)

    prev1, prev2 = context_prelude
    for cmd in commands:
        while cmd_count >= cmd_len and cmd_idx + 1 < command_split.num_blocks:
            cmd_idx += 1
            cmd_type = command_split.types[cmd_idx]
            cmd_len = command_split.lengths[cmd_idx]
            cmd_count = 0
        command_histograms[cmd_type][cmd.cmd_prefix] += 1
        cmd_count += 1
        for j in range(cmd.insert_len):
            while lit_count >= lit_len and lit_idx + 1 < literal_split.num_blocks:
                lit_idx += 1
                lit_type = literal_split.types[lit_idx]
                lit_len = literal_split.lengths[lit_idx]
                lit_count = 0
            literal = data[(pos + j) & mask]
            ctx = get_context(prev1, prev2, context_lut)
            literal_histograms[lit_type * NUM_LITERAL_CONTEXTS + ctx][literal] += 1
            lit_count += 1
            prev2 = prev1
            prev1 = literal
        pos += cmd.insert_len
        copy_len = cmd.copy_length()
        if copy_len and cmd.cmd_prefix >= 128:
            while dist_count >= dist_len and dist_idx + 1 < distance_split.num_blocks:
                dist_idx += 1
                dist_type = distance_split.types[dist_idx]
                dist_len = distance_split.lengths[dist_idx]
                dist_count = 0
            dist_code = cmd.dist_prefix & 0x3FF
            dist_ctx = 3 if copy_len > 4 else copy_len - 2
            distance_histograms[
                dist_type * NUM_DISTANCE_CONTEXTS + dist_ctx
            ][dist_code] += 1
            dist_count += 1
        if copy_len > 0:
            prev1 = data[(pos + copy_len - 1) & mask]
            prev2 = data[(pos + copy_len - 2) & mask]
        pos += copy_len

    # --- cluster ------------------------------------------------------------
    num_lit_clusters, literal_context_map = _cluster_and_build_context_map(
        literal_histograms, num_literal_contexts, NUM_LITERAL_SYMBOLS
    )
    num_dist_clusters, distance_context_map = _cluster_and_build_context_map(
        distance_histograms, num_distance_contexts, dist_alphabet_size
    )
    clustered_lit = _build_clustered_histograms(
        literal_histograms, literal_context_map, num_lit_clusters, NUM_LITERAL_SYMBOLS
    )
    clustered_dist = _build_clustered_histograms(
        distance_histograms, distance_context_map, num_dist_clusters, dist_alphabet_size
    )

    # --- store ---------------------------------------------------------------
    store_compressed_metablock_header(w, is_last, length)

    literal_enc = _BlockEncoder(
        NUM_LITERAL_SYMBOLS, literal_split.num_types,
        literal_split.types, literal_split.lengths, literal_split.num_blocks,
    )
    command_enc = _BlockEncoder(
        NUM_COMMAND_SYMBOLS, command_split.num_types,
        command_split.types, command_split.lengths, command_split.num_blocks,
    )
    distance_enc = _BlockEncoder(
        dist_alphabet_size, distance_split.num_types,
        distance_split.types, distance_split.lengths, distance_split.num_blocks,
    )
    literal_enc.build_and_store_entropy_codes(w)
    command_enc.build_and_store_entropy_codes(w)
    distance_enc.build_and_store_entropy_codes(w)

    w.write(2, npostfix)
    w.write(4, ndirect >> npostfix)
    for _ in range(literal_split.num_types):
        w.write(2, context_mode)
    encode_context_map(w, literal_context_map, num_lit_clusters)
    encode_context_map(w, distance_context_map, num_dist_clusters)

    literal_enc.build_and_store_huffman_trees(w, clustered_lit)
    command_enc.build_and_store_huffman_trees(w, command_histograms)
    distance_enc.build_and_store_huffman_trees(w, clustered_dist)

    pos = start_pos
    prev1, prev2 = context_prelude
    for cmd in commands:
        command_enc.store_symbol(w, cmd.cmd_prefix)
        store_command_extra(w, cmd)
        for j in range(cmd.insert_len):
            literal = data[(pos + j) & mask]
            ctx = get_context(prev1, prev2, context_lut)
            literal_enc.store_symbol_with_context(
                w, literal, ctx, literal_context_map, LITERAL_CONTEXT_BITS
            )
            prev2 = prev1
            prev1 = literal
        pos += cmd.insert_len
        copy_len = cmd.copy_length()
        if copy_len and cmd.cmd_prefix >= 128:
            dist_code = cmd.dist_prefix & 0x3FF
            dist_ctx = 3 if copy_len > 4 else copy_len - 2
            distance_enc.store_symbol_with_context(
                w, dist_code, dist_ctx, distance_context_map, DISTANCE_CONTEXT_BITS
            )
            w.write(cmd.dist_prefix >> 10, cmd.dist_extra)
        if copy_len > 0:
            prev1 = data[(pos + copy_len - 1) & mask]
            prev2 = data[(pos + copy_len - 2) & mask]
        pos += copy_len

    if is_last:
        w.align_to_byte()
