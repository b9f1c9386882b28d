"""The q10 Zopfli DP's driver passes and its window kernel
(brotli_tpu_torch.ops.device_zopfli) against the host q10 parse (the
port's create_zopfli_backward_references) and the plain PyTorch version
`zopfli_dp_ref`.

* zopfli_commands_device runs one DP pass where the host's quick step
  skips to the position the match schedule's long-match skip already took
  (bytes(20000); the 51,900-B runs input of utils.benchmarks.runs_input,
  seeded from numpy.random.default_rng).
* The window kernel's per-lane code (csrc/zopfli.cuh zopfli_lane_win,
  built by g++) at windows of 64 and 128 slots, so the window slides, jumps
  and relaxes past its end on short lanes, == zopfli_dp_ref on every
  output and == the host's commands; at several windows == the direct
  per-lane code on 64 KB and 8 KB lanes.
* launch_config against csrc/zopfli.cu's shared-memory layout.
* On a card only: the window kernel == the direct kernel ==
  zopfli_dp_ref, and a launch the kernel refuses raises.

Tolerance: exact (node arrays bit for bit, cost as float64; commands field
for field).  The card tests import no JAX:
    python3 -m pytest --noconftest -m cuda tests/test_torch_zopfli_step.py
"""

import re
from pathlib import Path

import pytest
import torch

from brotli_tpu_torch.ops import device_zopfli as Z
from brotli_tpu_torch.utils.benchmarks import corpus, runs_input
from test_torch_zopfli import LANE_SETS, _assert_same, _host, _tuples

CSRC = Path(__file__).resolve().parents[1] / "brotli_tpu_torch" / "csrc"


def _long_lanes() -> list[bytes]:
    """Lanes whose matches reach past a small window: a zero run, the runs
    input cut to 3 x 2,000 B, and text with a 700-byte repeat."""
    text = corpus(1500)
    return [bytes(3000), runs_input(run=1700), text + text[200:900]]


WINDOW_SETS = {**LANE_SETS, "long": _long_lanes}


# ---------------------------------------------------------------------------
# the driver's passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zeros", "runs"])
def test_one_pass_where_the_schedule_skipped(name, monkeypatch):
    """Each long run of these inputs gives a position whose result reaches
    the quick-step threshold (16,384), where the match collection's
    long-match skip already took the host's quick step: one DP pass, the
    host's commands.  (Before the repair: 2 passes for bytes(20000), 4
    for the runs input.)"""
    data = bytes(20000) if name == "zeros" else runs_input()
    passes = []
    dp = Z.zopfli_dp
    monkeypatch.setattr(Z, "zopfli_dp", lambda zb: passes.append(1) or dp(zb))
    cmds, last = Z.zopfli_commands_device(data, device="cpu")
    host_cmds, host_last = _host(data)
    assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
    assert len(passes) == 1
    zb = Z.stage_zopfli([data], device="cpu")
    result = Z.zopfli_dp_ref(zb).result[0]
    assert int(result.max()) >= Z.LONG_COPY_QUICK_STEP


# ---------------------------------------------------------------------------
# the window kernel's per-lane code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [64, 128])
@pytest.mark.parametrize("name", sorted(WINDOW_SETS))
def test_window_shim_equals_plain_and_host(name, window):
    """zopfli_dp_host(window=...) == zopfli_dp_ref on every output, lanes
    of unequal length in one batch, and each lane's backtrack == the
    host's."""
    lanes = WINDOW_SETS[name]()
    zb = Z.stage_zopfli(lanes, device="cpu")
    ref = Z.zopfli_dp_ref(zb)
    _assert_same(ref, Z.zopfli_dp_host(zb, window=window))
    for b, data in enumerate(lanes):
        cmds, last = Z.backtrack(ref, b, len(data))
        host_cmds, host_last = _host(data)
        assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
    if name == "long":
        # matches relaxed past the window: lengths beyond 2 x 128 slots
        assert int(ref.result.max()) > 2 * window


def test_window_shim_equals_direct_on_long_lanes():
    """At windows from 64 slots to one larger than the lane, the window
    code == the direct kernel's per-lane code on 64 KB of the corpus, two 8 KB
    lanes and the runs input in one batch (the lanes' commands are the
    host's: test_torch_zopfli.py and chip_smoke.py hold those)."""
    big = corpus(65536 + 2 * 8192)
    lanes = [big[:65536], big[65536:73728], big[73728:], runs_input()]
    zb = Z.stage_zopfli(lanes, device="cpu")
    direct = Z.zopfli_dp_host(zb)
    assert int(direct.tried.sum()) > 0
    for window in (64, 1024, 8192, 131072):
        _assert_same(direct, Z.zopfli_dp_host(zb, window=window))


@pytest.mark.parametrize("window", [0, 32, 96])
def test_window_shim_refuses_bad_windows(window):
    zb = Z.stage_zopfli([b"abcabcabcabc"], device="cpu")
    with pytest.raises(ValueError, match="refused"):
        Z.zopfli_dp_host(zb, window=window)


# ---------------------------------------------------------------------------
# launch_config
# ---------------------------------------------------------------------------

H100 = dict(sms=132, smem_block=232448, smem_sm=233472)


@pytest.mark.parametrize("lanes,n_max,want", [
    (1, 65536, (1, 2048)), (32, 8192, (32, 2048)), (2, 2048, (2, 2048)),
    (1, 10, (1, 64)), (1056, 4096, (1056, 128)), (100000, 64, (1056, 128))])
def test_launch_config(lanes, n_max, want):
    """The grid and window on an H100's shared memory: the window is a
    power of two of at least WINDOW_MIN slots, no larger than the lane
    needs, and the blocks an SM holds fit its shared memory."""
    blocks, window = Z.launch_config(lanes, n_max, **H100)
    assert (blocks, window) == want
    assert window & (window - 1) == 0 and window >= Z.WINDOW_MIN
    per_sm = -(-blocks // H100["sms"])
    smem = Z.TABLE_BYTES + Z.SLOT_BYTES * window
    assert smem <= H100["smem_block"]
    assert per_sm * (smem + 1024) <= H100["smem_sm"] or window == Z.WINDOW_MIN


def test_layout_matches_the_cuda_source():
    """TABLE_BYTES, SLOT_BYTES and WINDOW_MIN against csrc/zopfli.cu's
    dynamic shared memory: the tables, then a slot's words."""
    cu = (CSRC / "zopfli.cu").read_text()
    const = dict(re.findall(r"constexpr int (ZOPFLI_\w+) = (\d+);", cu))
    assert "sizeof(double) * (size_t)ZOPFLI_TABLES + (size_t)ZOPFLI_SLOT" in cu
    assert "ZOPFLI_TABLES = ZOPFLI_NUM_CMD + ZOPFLI_DIST_ROW" in cu
    assert Z.TABLE_BYTES == 8 * (Z.NUM_CMD + Z.DIST_ROW)
    # cost and literal cost; len, dist, dci, sc and the noted next; a
    # record and a noted walk of 4 words
    assert int(const["ZOPFLI_SLOT"]) == Z.SLOT_BYTES == 8 + 8 + 5 * 4 + 2 * 16
    assert int(const["ZOPFLI_WINDOW_MIN"]) == Z.WINDOW_MIN
    assert "(i32*)(fields + 5 * window)" in cu   # the records after 5 fields
    assert "(i32*)(fields + 9 * window)" in cu   # the walks after them


# ---------------------------------------------------------------------------
# the card (no JAX)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_window_kernel_equals_direct_and_plain_on_card(monkeypatch):
    """The window kernel == the direct kernel == zopfli_dp_ref on CUDA
    tensors, 2 lanes x 2 KB, every output bit for bit; the runs input
    through device="cuda" in one window-kernel launch; a window the kernel
    refuses raises, with no fallback (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    big = corpus(65536 + 2 * 2048)[65536:]
    zb = Z.stage_zopfli([big[:2048], big[2048:]], device="cuda")
    before = (Z.KERNEL_LAUNCHES, Z.DIRECT_LAUNCHES)
    new, old = Z.zopfli_dp(zb), Z.zopfli_dp_direct(zb)
    assert (Z.KERNEL_LAUNCHES, Z.DIRECT_LAUNCHES) == (before[0] + 1,
                                                      before[1] + 1)
    ref = Z.zopfli_dp_ref(zb)
    _assert_same(new, ref)
    _assert_same(old, ref)
    data = runs_input()
    before = Z.KERNEL_LAUNCHES
    cmds, last = Z.zopfli_commands_device(data, device="cuda")
    assert Z.KERNEL_LAUNCHES == before + 1
    host_cmds, host_last = _host(data)
    assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
    monkeypatch.setattr(Z, "launch_config", lambda *a: (1, 32))
    with pytest.raises(RuntimeError, match="launch failed"):
        Z.zopfli_dp(zb)
