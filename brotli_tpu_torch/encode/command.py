"""Command representation: a literal run followed by a backward reference.

Layout matches the reference (command.ts:140-208): copy_len packs a 7-bit
length-code delta in the high bits; dist_prefix packs the extra-bit count
above bit 10.  These feed directly into SoA tensors on the device path.
"""

from __future__ import annotations

from ..constants import (
    COPY_LENGTH_N_BITS,
    COPY_LENGTH_OFFSET,
    INSERT_LENGTH_N_BITS,
    INSERT_LENGTH_OFFSET,
    combine_length_codes,
    get_copy_length_code,
    get_insert_length_code,
)

NUM_DISTANCE_SHORT_CODES = 16

_INS_BASE = INSERT_LENGTH_OFFSET.tolist()
_INS_EXTRA = INSERT_LENGTH_N_BITS.tolist()
_CP_BASE = COPY_LENGTH_OFFSET.tolist()
_CP_EXTRA = COPY_LENGTH_N_BITS.tolist()


class Command:
    __slots__ = ("insert_len", "copy_len", "dist_extra", "cmd_prefix", "dist_prefix")

    def __init__(self, insert_len, copy_len, dist_extra, cmd_prefix, dist_prefix):
        self.insert_len = insert_len
        self.copy_len = copy_len          # low 25 bits: length; high 7: code delta
        self.dist_extra = dist_extra
        self.cmd_prefix = cmd_prefix      # 0..703
        self.dist_prefix = dist_prefix    # low 10 bits: code; high 6: n extra bits

    def copy_length(self) -> int:
        return self.copy_len & 0x1FFFFFF

    def copy_length_code(self) -> int:
        mod = self.copy_len >> 25
        delta = mod | ~0x7F if (mod & 0x40) else mod  # sign-extend 7 bits
        return (self.copy_len & 0x1FFFFFF) + delta

    def dist_code(self) -> int:
        return self.dist_prefix & 0x3FF

    def __repr__(self):
        return (
            f"Command(ins={self.insert_len}, copy={self.copy_length()}, "
            f"cmd={self.cmd_prefix}, dist={self.dist_prefix & 0x3FF})"
        )


def prefix_encode_copy_distance(
    distance_code: int, ndirect: int, npostfix: int
) -> tuple[int, int, int]:
    """distance code (0-15 short | 16+distance-1) -> (code, extra_val, extra_nbits)."""
    if distance_code < NUM_DISTANCE_SHORT_CODES + ndirect:
        return distance_code, 0, 0
    dist = (1 << (npostfix + 2)) + (distance_code - NUM_DISTANCE_SHORT_CODES - ndirect)
    bucket = dist.bit_length() - 2
    postfix_mask = (1 << npostfix) - 1
    postfix = dist & postfix_mask
    prefix = (dist >> bucket) & 1
    offset = (2 + prefix) << bucket
    nbits = bucket - npostfix
    code = (
        NUM_DISTANCE_SHORT_CODES
        + ndirect
        + ((2 * (nbits - 1) + prefix) << npostfix)
        + postfix
    )
    return code, (dist - offset) >> npostfix, nbits


def make_command(
    insert_len: int,
    copy_len: int,
    copy_len_code_delta: int,
    distance_code: int,
    ndirect: int = 0,
    npostfix: int = 0,
) -> Command:
    delta = copy_len_code_delta & 0x7F
    dist_code, dist_extra, dist_nbits = prefix_encode_copy_distance(
        distance_code, ndirect, npostfix
    )
    use_last = (dist_code & 0x3FF) == 0
    cmd_prefix = combine_length_codes(
        get_insert_length_code(insert_len),
        get_copy_length_code(copy_len + copy_len_code_delta),
        use_last,
    )
    return Command(
        insert_len,
        copy_len | (delta << 25),
        dist_extra,
        cmd_prefix,
        dist_code | (dist_nbits << 10),
    )


def make_insert_command(insert_len: int) -> Command:
    """Insert-only command: copy length 0, coded as copy-code 2 w/ last distance."""
    ins_code = get_insert_length_code(insert_len)
    # copy length code 2 (minimum); implicit last-distance cell when possible
    cmd_prefix = combine_length_codes(ins_code, get_copy_length_code(2), ins_code < 8)
    return Command(insert_len, 0 | (2 << 25), 0, cmd_prefix, 0)


DISTANCE_CACHE_INDEX = [0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1]
DISTANCE_CACHE_OFFSET = [0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3]


def distance_to_code(distance: int, dist_cache) -> int:
    """Backward distance -> distance code (0-15 cache refs, else dist+15)."""
    for i in range(NUM_DISTANCE_SHORT_CODES):
        cached = dist_cache[DISTANCE_CACHE_INDEX[i]] + DISTANCE_CACHE_OFFSET[i]
        if distance == cached and cached > 0:
            return i
    return distance + NUM_DISTANCE_SHORT_CODES - 1


def store_command_extra(w, cmd: Command) -> None:
    """Write the insert+copy extra bits, packed together (metablock.ts:257-276)."""
    copy_len_code = cmd.copy_length_code()
    ins_code = get_insert_length_code(cmd.insert_len)
    copy_code = get_copy_length_code(copy_len_code)
    ins_n = _INS_EXTRA[ins_code]
    ins_v = cmd.insert_len - _INS_BASE[ins_code]
    cp_v = copy_len_code - _CP_BASE[copy_code]
    w.write(ins_n + _CP_EXTRA[copy_code], (cp_v << ins_n) | ins_v)
