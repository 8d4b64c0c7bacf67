"""Integer helpers (copy of ``claragenomicsanalysis_tpu/utils/mathutils.py``,
the part the port runs)."""


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
