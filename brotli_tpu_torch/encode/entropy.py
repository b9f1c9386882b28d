"""Huffman code construction and serialized tree storage (encoder side).

Depth assignment must be byte-for-byte compatible with the reference
(the reference library's src/encode/entropy-encode.ts): identical count-limit retry
loop, identical tie-breaking (leaves created in reverse symbol order; sort
ascending by count with ties preferring the LARGER symbol; two-queue merge
preferring the leaf queue on equal counts).  Any deviation changes code
lengths and therefore the output stream.
"""

from __future__ import annotations

from .bitwriter import BitWriter

MAX_HUFFMAN_BITS = 15
REPEAT_PREVIOUS = 16
REPEAT_ZERO = 17
CODE_LENGTH_CODES = 18

# Storage order + fixed code for the code-length code (RFC 3.5).
CODE_LENGTH_STORAGE_ORDER = [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15]
_CLCL_SYMBOLS = [0, 7, 3, 2, 1, 15]   # wire codes for lengths 0..5
_CLCL_NBITS = [2, 4, 3, 2, 2, 4]


def create_huffman_depths(histogram, alphabet_size: int, tree_limit: int) -> list[int]:
    """Package-merge-free Huffman with count-limit retry (matches reference)."""
    depths = [0] * alphabet_size
    leaves = [(i, int(histogram[i])) for i in range(alphabet_size) if histogram[i] > 0]
    if not leaves:
        return depths
    if len(leaves) == 1:
        depths[leaves[0][0]] = 1
        return depths

    count_limit = 1
    while True:
        # leaf nodes in reverse symbol order, clamped counts
        counts = []
        values = []
        for i in range(alphabet_size - 1, -1, -1):
            h = int(histogram[i])
            if h > 0:
                counts.append(max(h, count_limit))
                values.append(i)
        n = len(counts)
        # sort ascending by count; ties broken by larger symbol value
        order = sorted(range(n), key=lambda k: (counts[k], -values[k]))
        node_count = [counts[k] for k in order] + [0xFFFFFFFF, 0xFFFFFFFF] + [0] * n
        node_left = [-1] * n + [-1, -1] + [0] * n
        node_right = [values[k] for k in order] + [-1, -1] + [0] * n

        i = 0       # next leaf
        j = n + 1   # next internal node
        for k in range(n - 1, 0, -1):
            if node_count[i] <= node_count[j]:
                left = i
                i += 1
            else:
                left = j
                j += 1
            if node_count[i] <= node_count[j]:
                right = i
                i += 1
            else:
                right = j
                j += 1
            j_end = 2 * n - k
            node_count[j_end] = node_count[left] + node_count[right]
            node_left[j_end] = left
            node_right[j_end] = right
            if j_end + 1 < len(node_count):
                node_count[j_end + 1] = 0xFFFFFFFF
                node_left[j_end + 1] = -1
                node_right[j_end + 1] = -1
            else:
                node_count.append(0xFFFFFFFF)
                node_left.append(-1)
                node_right.append(-1)

        if _set_depths(2 * n - 1, node_left, node_right, depths, tree_limit):
            return depths
        for k in range(alphabet_size):
            depths[k] = 0
        count_limit *= 2


def _set_depths(root, node_left, node_right, depths, max_depth) -> bool:
    stack = [(root, 0)]
    while stack:
        p, level = stack.pop()
        if node_left[p] >= 0:
            if level + 1 > max_depth:
                return False
            stack.append((node_left[p], level + 1))
            stack.append((node_right[p], level + 1))
        else:
            depths[node_right[p]] = level
    return True


def _reverse_bits(nbits: int, bits: int) -> int:
    return int(format(bits, f"0{nbits}b")[::-1], 2) if nbits else 0


def depths_to_bits(depths) -> list[int]:
    """Canonical code assignment with LSB-first bit reversal."""
    bl_count = [0] * (MAX_HUFFMAN_BITS + 1)
    for d in depths:
        bl_count[d] += 1
    bl_count[0] = 0
    next_code = [0] * (MAX_HUFFMAN_BITS + 1)
    code = 0
    for ln in range(1, MAX_HUFFMAN_BITS + 1):
        code = (code + bl_count[ln - 1]) << 1
        next_code[ln] = code
    bits = [0] * len(depths)
    for i, d in enumerate(depths):
        if d > 0:
            bits[i] = _reverse_bits(d, next_code[d])
            next_code[d] += 1
    return bits


# ---------------------------------------------------------------------------
# Serialized tree storage (RFC 3.4/3.5 writer side)
# ---------------------------------------------------------------------------

def _write_tree_repetitions(prev, value, reps, tree, extra) -> None:
    if prev != value:
        tree.append(value)
        extra.append(0)
        reps -= 1
    if reps == 7:
        tree.append(value)
        extra.append(0)
        reps -= 1
    if reps < 3:
        for _ in range(reps):
            tree.append(value)
            extra.append(0)
    else:
        reps -= 3
        start = len(tree)
        while True:
            tree.append(REPEAT_PREVIOUS)
            extra.append(reps & 3)
            reps >>= 2
            if reps == 0:
                break
            reps -= 1
        tree[start:] = tree[start:][::-1]
        extra[start:] = extra[start:][::-1]


def _write_tree_zeros(reps, tree, extra) -> None:
    if reps == 11:
        tree.append(0)
        extra.append(0)
        reps -= 1
    if reps < 3:
        for _ in range(reps):
            tree.append(0)
            extra.append(0)
    else:
        reps -= 3
        start = len(tree)
        while True:
            tree.append(REPEAT_ZERO)
            extra.append(reps & 7)
            reps >>= 3
            if reps == 0:
                break
            reps -= 1
        tree[start:] = tree[start:][::-1]
        extra[start:] = extra[start:][::-1]


def write_huffman_tree_rle(depths, length: int) -> tuple[list[int], list[int]]:
    """Depths -> (code-length symbols, extra bits) RLE stream.

    Matches metablock-side representation (context-map.ts:382-470): runs are
    always detected (unconditional reps counting), unlike the entropy-encode
    variant that gates on useRle heuristics — the reference stores metablock
    trees via this unconditional form.
    """
    tree: list[int] = []
    extra: list[int] = []
    new_length = length
    while new_length > 0 and depths[new_length - 1] == 0:
        new_length -= 1
    prev = 8
    i = 0
    while i < new_length:
        value = depths[i]
        reps = 1
        while i + reps < new_length and depths[i + reps] == value:
            reps += 1
        i += reps
        if value == 0:
            _write_tree_zeros(reps, tree, extra)
        else:
            _write_tree_repetitions(prev, value, reps, tree, extra)
            prev = value
    return tree, extra


def _store_code_length_code(w: BitWriter, num_codes: int, cl_depths) -> None:
    """Store the code-length code's own lengths (context-map.ts:485-520)."""
    codes_to_store = CODE_LENGTH_CODES
    if num_codes > 1:
        while (
            codes_to_store > 0
            and cl_depths[CODE_LENGTH_STORAGE_ORDER[codes_to_store - 1]] == 0
        ):
            codes_to_store -= 1
    skip_some = 0
    if (
        cl_depths[CODE_LENGTH_STORAGE_ORDER[0]] == 0
        and cl_depths[CODE_LENGTH_STORAGE_ORDER[1]] == 0
    ):
        skip_some = 2
        if cl_depths[CODE_LENGTH_STORAGE_ORDER[2]] == 0:
            skip_some = 3
    w.write(2, skip_some)
    for i in range(skip_some, codes_to_store):
        ln = cl_depths[CODE_LENGTH_STORAGE_ORDER[i]]
        w.write(_CLCL_NBITS[ln], _CLCL_SYMBOLS[ln])


def build_huffman_code(histogram, alphabet_size: int):
    """Build (depths, bits, count, s4) from a histogram without storing."""
    count = 0
    s4 = [0, 0, 0, 0]
    for i in range(alphabet_size):
        if histogram[i]:
            if count < 4:
                s4[count] = i
            count += 1
    if count <= 1:
        return [0] * alphabet_size, [0] * alphabet_size, count, s4
    depths = create_huffman_depths(histogram, alphabet_size, MAX_HUFFMAN_BITS)
    bits = depths_to_bits(depths)
    return depths, bits, count, s4


def store_huffman_tree(
    w: BitWriter, depths, alphabet_size: int, count: int, s4
) -> None:
    """Store a previously-built code's tree description (RFC 3.4/3.5)."""
    max_bits = (alphabet_size - 1).bit_length()
    if count <= 1:
        # 4 bits: HSKIP=1 (2 bits) + NSYM-1=0 (2 bits)
        w.write(4, 1)
        w.write(max_bits, s4[0])
    elif count <= 4:
        _store_simple_tree(w, depths, s4, count, max_bits)
    else:
        _store_complex_tree(w, depths, alphabet_size)


def build_and_store_huffman_tree(
    w: BitWriter, histogram, alphabet_size: int
) -> tuple[list[int], list[int]]:
    """Build a code from `histogram`, store its description, return
    (depths, bits) for subsequent symbol emission."""
    depths, bits, count, s4 = build_huffman_code(histogram, alphabet_size)
    store_huffman_tree(w, depths, alphabet_size, count, s4)
    return depths, bits


def _store_simple_tree(w, depths, symbols, num_symbols, max_bits) -> None:
    syms = sorted(symbols[:num_symbols], key=lambda s: depths[s])
    w.write(2, 1)  # simple code marker
    w.write(2, num_symbols - 1)
    for s in syms:
        w.write(max_bits, s)
    if num_symbols == 4:
        w.write(1, 1 if depths[syms[0]] == 1 else 0)


def _store_complex_tree(w, depths, length) -> None:
    tree, extra = write_huffman_tree_rle(depths, length)
    cl_hist = [0] * CODE_LENGTH_CODES
    for code in tree:
        cl_hist[code] += 1
    num_codes = 0
    first_code = 0
    for i in range(CODE_LENGTH_CODES):
        if cl_hist[i]:
            if num_codes == 0:
                first_code = i
            num_codes += 1
    cl_depths = create_huffman_depths(cl_hist, CODE_LENGTH_CODES, 5)
    cl_bits = depths_to_bits(cl_depths)
    _store_code_length_code(w, num_codes, cl_depths)
    if num_codes == 1:
        cl_depths[first_code] = 0
    for code, eb in zip(tree, extra):
        w.write(cl_depths[code], cl_bits[code])
        if code == REPEAT_PREVIOUS:
            w.write(2, eb)
        elif code == REPEAT_ZERO:
            w.write(3, eb)
