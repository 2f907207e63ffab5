"""Delphi-style event vocabulary: ICD-10-chapter-structured disease codes.

Layout (matching the Delphi convention of specials + static + disease codes):
  0            PAD
  1            DEATH          (the termination token, paper default)
  2            NO_EVENT       (5-yearly "no event" marker, loss-masked)
  3..4         sex            (female / male)
  5..12        lifestyle      (BMI / smoking / alcohol tertiles-ish)
  13..1288     disease codes  (1276 codes across 26 ICD-10 chapters A..Z)

Total vocab = 1289 (``configs/delphi_2m.py``).
"""
from __future__ import annotations

from typing import List

PAD = 0
DEATH = 1
NO_EVENT = 2
SEX_FEMALE = 3
SEX_MALE = 4
LIFESTYLE0 = 5
N_LIFESTYLE = 8
DISEASE0 = 13
N_DISEASE = 1276
VOCAB_SIZE = DISEASE0 + N_DISEASE  # 1289

N_CHAPTERS = 26
_PER_CHAPTER = -(-N_DISEASE // N_CHAPTERS)


def chapter_of(code: int) -> int:
    """ICD-10 chapter index (0..25) of a disease code."""
    assert DISEASE0 <= code < VOCAB_SIZE
    return (code - DISEASE0) // _PER_CHAPTER


def code_name(code: int) -> str:
    """Human-readable ICD-ish label, e.g. 'C12.3' (used by the SDK display)."""
    if code == PAD:
        return "<pad>"
    if code == DEATH:
        return "Death"
    if code == NO_EVENT:
        return "No event"
    if code in (SEX_FEMALE, SEX_MALE):
        return "Sex:F" if code == SEX_FEMALE else "Sex:M"
    if LIFESTYLE0 <= code < DISEASE0:
        return f"Lifestyle:{code - LIFESTYLE0}"
    ch = chapter_of(code)
    within = (code - DISEASE0) % _PER_CHAPTER
    return f"{chr(ord('A') + ch)}{within // 10:02d}.{within % 10}"


def all_names() -> List[str]:
    return [code_name(c) for c in range(VOCAB_SIZE)]
