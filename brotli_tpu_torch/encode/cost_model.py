"""Zopfli cost model (zopfli-cost-model.ts).

Bit-exactness requires replicating the reference's float precision dance:
cost arrays are Float32 (values round-trip through f32 on store), arithmetic
happens in f64, and the cumulative literal-cost array uses Kahan-style carry
compensation with f32 storage.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import NUM_COMMAND_SYMBOLS, NUM_LITERAL_SYMBOLS

INFINITY_COST = 1.7e38
_LOG2_INV = 1.4426950408889634

# exact f64 log2 table for 0..255 (log2(0) := 0), same values as the reference
_LOG2_TABLE = [0.0, 0.0] + [math.log(i) * _LOG2_INV for i in range(2, 256)]


def fast_log2(v) -> float:
    if v < 256:
        return _LOG2_TABLE[int(v)]
    return math.log(v) * _LOG2_INV


class ZopfliCostModel:
    def __init__(self, num_bytes: int, distance_alphabet_size: int):
        self.num_bytes = num_bytes
        self.dist_size = distance_alphabet_size
        self.cost_cmd = np.zeros(NUM_COMMAND_SYMBOLS, dtype=np.float32)
        self.cost_dist = np.zeros(distance_alphabet_size, dtype=np.float32)
        self.literal_costs = np.zeros(num_bytes + 2, dtype=np.float32)
        self.min_cost_cmd = INFINITY_COST

    # -- first pass ---------------------------------------------------------
    def set_from_literal_costs(self, position: int, data, mask: int) -> None:
        costs = self._estimate_literal_costs(position, data, mask)
        self._accumulate_literal_costs(position, data, mask, costs)
        for i in range(NUM_COMMAND_SYMBOLS):
            self.cost_cmd[i] = fast_log2(11 + i)
        for i in range(self.dist_size):
            self.cost_dist[i] = fast_log2(20 + i)
        self.min_cost_cmd = fast_log2(11)

    def _estimate_literal_costs(self, position, data, mask) -> list[float]:
        hist = [0] * NUM_LITERAL_SYMBOLS
        n = self.num_bytes
        for i in range(n):
            hist[data[(position + i) & mask]] += 1
        log2total = fast_log2(n)
        costs = [0.0] * NUM_LITERAL_SYMBOLS
        for i in range(NUM_LITERAL_SYMBOLS):
            if hist[i] == 0:
                costs[i] = log2total + 2
            else:
                c = log2total - fast_log2(hist[i])
                costs[i] = c if c >= 1 else 1.0
        return costs

    def _accumulate_literal_costs(self, position, data, mask, byte_costs) -> None:
        """Carry-compensated cumulative sum with f32 storage (reference :46-52)."""
        lc = self.literal_costs
        lc[0] = 0.0
        carry = 0.0
        prev = 0.0  # lc[i] as f32-rounded float
        for i in range(self.num_bytes):
            carry += byte_costs[data[(position + i) & mask]]
            cur = np.float32(prev + carry)
            lc[i + 1] = cur
            carry -= float(cur) - prev
            prev = float(cur)

    # -- second pass ---------------------------------------------------------
    def set_from_commands(self, position, data, mask, commands, last_insert_len) -> None:
        hist_lit = [0] * NUM_LITERAL_SYMBOLS
        hist_cmd = [0] * NUM_COMMAND_SYMBOLS
        hist_dist = [0] * self.dist_size
        pos = position - last_insert_len
        for cmd in commands:
            hist_cmd[cmd.cmd_prefix] += 1
            if cmd.cmd_prefix >= 128:
                hist_dist[cmd.dist_prefix & 0x3FF] += 1
            for j in range(cmd.insert_len):
                hist_lit[data[(pos + j) & mask]] += 1
            pos += cmd.insert_len + cmd.copy_length()

        cost_lit = np.zeros(NUM_LITERAL_SYMBOLS, dtype=np.float32)
        self._set_cost(hist_lit, True, cost_lit)
        self._set_cost(hist_cmd, False, self.cost_cmd)
        self._set_cost(hist_dist, False, self.cost_dist)
        self.min_cost_cmd = float(np.min(self.cost_cmd))
        self._accumulate_literal_costs(
            position, data, mask, [float(c) for c in cost_lit]
        )

    def _set_cost(self, histogram, is_literal, cost: np.ndarray) -> None:
        total = sum(histogram)
        log2sum = fast_log2(total)
        missing_sum = total
        if not is_literal:
            missing_sum += sum(1 for h in histogram if h == 0)
        missing_cost = fast_log2(missing_sum) + 2
        for i, h in enumerate(histogram):
            if h == 0:
                cost[i] = missing_cost
            else:
                cost[i] = log2sum - fast_log2(h)
                if cost[i] < 1:
                    cost[i] = 1
    # -- accessors ------------------------------------------------------------

    def get_command_cost(self, cmd_code: int) -> float:
        return float(self.cost_cmd[cmd_code])

    def get_distance_cost(self, dist_code: int) -> float:
        """OOB lookups (reference quirk: index >= alphabet) poison the cost."""
        if dist_code >= self.dist_size:
            return math.inf
        return float(self.cost_dist[dist_code])

    def get_literal_costs(self, from_pos: int, to_pos: int) -> float:
        return float(self.literal_costs[to_pos]) - float(self.literal_costs[from_pos])

    def get_min_cost_cmd(self) -> float:
        return self.min_cost_cmd
