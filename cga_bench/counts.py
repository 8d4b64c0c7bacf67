"""The port's counters of the traced window, for the metrics of source
``program_counter``.  The harness closes its ``stage_times()`` block before
it reads the metrics, so the block's counters are those of the program's
``profiling.last_counters()``.  A port without counters gives None, and its
metrics are left out of the line."""


def window_counts() -> dict[str, int] | None:
    from claragenomicsanalysis_tpu_torch.utils import profiling
    last = getattr(profiling, "last_counters", None)
    return None if last is None else last()
