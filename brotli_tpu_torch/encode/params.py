"""Encoder parameters and quality thresholds.

Mirrors the observable behavior of the reference's params system
(the reference library's src/encode/enc-constants.ts:86-147): clamping rules,
FONT-mode distance params, and lgblock computation all reach the bitstream
and must match exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MIN_QUALITY = 0
MAX_QUALITY = 11
DEFAULT_QUALITY = 11
ZOPFLIFICATION_QUALITY = 10
HQ_ZOPFLIFICATION_QUALITY = 11

MAX_QUALITY_FOR_STATIC_ENTROPY_CODES = 2
MIN_QUALITY_FOR_BLOCK_SPLIT = 4
MIN_QUALITY_FOR_NONZERO_DISTANCE_PARAMS = 4
MIN_QUALITY_FOR_OPTIMIZE_HISTOGRAMS = 4
MIN_QUALITY_FOR_EXTENSIVE_REFERENCE_SEARCH = 5
MIN_QUALITY_FOR_CONTEXT_MODELING = 5
MIN_QUALITY_FOR_HQ_CONTEXT_MODELING = 7
MIN_QUALITY_FOR_HQ_BLOCK_SPLITTING = 10

MIN_WINDOW_BITS = 10
MAX_WINDOW_BITS = 24
LARGE_MAX_WINDOW_BITS = 30
DEFAULT_WINDOW_BITS = 22

MIN_INPUT_BLOCK_BITS = 16
MAX_INPUT_BLOCK_BITS = 24

MODE_GENERIC = 0
MODE_TEXT = 1
MODE_FONT = 2


@dataclass
class DistanceParams:
    npostfix: int = 0
    ndirect: int = 0


@dataclass
class EncoderParams:
    mode: int = MODE_GENERIC
    quality: int = DEFAULT_QUALITY
    lgwin: int = DEFAULT_WINDOW_BITS
    lgblock: int = 0
    size_hint: int = 0
    large_window: bool = False
    # Honor lgwin as the match-search window instead of the reference's
    # lgwin-independent (1<<22)-16 quirk (SURVEY section 5 "known limitation
    # to fix").  Off by default: the quirk reaches the bitstream and the
    # golden-locked outputs replicate it.
    honor_lgwin: bool = False
    dist: DistanceParams = field(default_factory=DistanceParams)

    def sanitize(self) -> "EncoderParams":
        self.quality = max(MIN_QUALITY, min(MAX_QUALITY, self.quality))
        if self.quality <= MAX_QUALITY_FOR_STATIC_ENTROPY_CODES:
            self.large_window = False
        max_lgwin = LARGE_MAX_WINDOW_BITS if self.large_window else MAX_WINDOW_BITS
        self.lgwin = max(MIN_WINDOW_BITS, min(max_lgwin, self.lgwin))
        if (
            self.quality >= MIN_QUALITY_FOR_NONZERO_DISTANCE_PARAMS
            and self.mode == MODE_FONT
        ):
            self.dist.npostfix = 1
            self.dist.ndirect = 12
        self.lgblock = self._compute_lgblock()
        return self

    def _compute_lgblock(self) -> int:
        lgblock = self.lgblock
        if self.quality in (0, 1):
            lgblock = self.lgwin
        elif self.quality < MIN_QUALITY_FOR_BLOCK_SPLIT:
            lgblock = 14
        elif lgblock == 0:
            lgblock = 16
            if self.quality >= 9 and self.lgwin > lgblock:
                lgblock = min(18, self.lgwin)
        else:
            lgblock = max(MIN_INPUT_BLOCK_BITS, min(MAX_INPUT_BLOCK_BITS, lgblock))
        return lgblock

    @property
    def dist_alphabet_size(self) -> int:
        return 16 + self.dist.ndirect + (48 << self.dist.npostfix)


def make_params(
    quality: int | None = None,
    lgwin: int | None = None,
    mode: int | None = None,
    size_hint: int | None = None,
    honor_lgwin: bool = False,
) -> EncoderParams:
    p = EncoderParams()
    if quality is not None:
        p.quality = max(0, min(11, quality))
    if lgwin is not None:
        p.lgwin = max(10, min(24, lgwin))
    if mode is not None:
        p.mode = mode
    if size_hint is not None:
        p.size_hint = size_hint
    p.honor_lgwin = honor_lgwin
    return p.sanitize()
