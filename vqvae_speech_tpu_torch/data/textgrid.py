"""Minimal Praat TextGrid parser (interval tiers only).

A copy of ``vqvae_speech_tpu/data/textgrid.py`` (the port imports nothing of
the JAX package), held equal to it by tests/test_torch_data.py.

Replaces the reference's third-party ``textgrid`` dependency (used at
reference src/dataset/vctk_dataset.py:105-115 and throughout
src/evaluation/alignment_stats.py for phoneme tiers).  Supports both the
long ("ooTextFile") format used by the VCTK phoneme alignments.
"""
import re
from dataclasses import dataclass
from typing import List


@dataclass
class Interval:
    minTime: float
    maxTime: float
    mark: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval]

    def __iter__(self):
        return iter(self.intervals)


@dataclass
class TextGrid:
    tiers: List[Tier]


_NUM = re.compile(r"(?:xmin|xmax)\s*=\s*([0-9.eE+-]+)")
_TEXT = re.compile(r'text\s*=\s*"(.*)"')
_NAME = re.compile(r'name\s*=\s*"(.*)"')


def read_textgrid(path: str) -> TextGrid:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = f.readlines()

    tiers: List[Tier] = []
    cur_tier = None
    xmin = xmax = None
    for line in lines:
        s = line.strip()
        if "class" in s and "IntervalTier" in s:
            cur_tier = Tier(name="", intervals=[])
            tiers.append(cur_tier)
            xmin = xmax = None
            continue
        if cur_tier is None:
            continue
        m = _NAME.search(s)
        if m and not cur_tier.name:
            cur_tier.name = m.group(1)
            continue
        if s.startswith("xmin"):
            xmin = float(s.split("=")[1])
            continue
        if s.startswith("xmax"):
            xmax = float(s.split("=")[1])
            continue
        m = _TEXT.search(s)
        if m and xmin is not None and xmax is not None:
            cur_tier.intervals.append(Interval(xmin, xmax, m.group(1)))
            xmin = xmax = None
    return TextGrid(tiers=tiers)


def phoneme_marks(path: str, exclude=("utt",)):
    """All labeled intervals across tiers as (xmin, xmax, mark) tuples,
    skipping empty marks and ``exclude`` (the synthetic corpus writes an
    utterance-level tier marked 'utt' above the phoneme tier)."""
    tg = read_textgrid(path)
    return [(iv.minTime, iv.maxTime, iv.mark)
            for tier in tg.tiers for iv in tier
            if iv.mark and iv.mark not in exclude]


def leading_silence_duration(path: str, tier_index: int = 1,
                             sil_mark: str = "sil") -> float:
    """Sum of leading 'sil' interval durations in the phoneme tier
    (reference vctk_dataset.py:105-115 reads tiers[1])."""
    tg = read_textgrid(path)
    if tier_index >= len(tg.tiers):
        return 0.0
    total = 0.0
    for interval in tg.tiers[tier_index]:
        if interval.mark != sil_mark:
            break
        total += interval.maxTime - interval.minTime
    return total
