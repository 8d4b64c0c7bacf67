"""What the metric readers (``metrics/<name>.py``) share.  A reader takes
the run's records and returns its number, or None where the run has
nothing for it to read.

The records: ``bases`` and ``mbp`` (read bases of the completed jobs),
``elapsed_s`` (first job's start to last job's end), ``setup_s``,
``jobs``, ``peak_bytes`` (``max_memory_allocated`` over the window); in a
traced run also ``host_ms`` (host ms inside each of the port's
``trace_range`` names), ``kernel_ms`` (CUDA-event ms of each hand-written
kernel), ``myers`` (B4's bound and event seconds), and from
``torch.profiler`` ``busy_s`` and ``window_s``."""


def host_ms(rec: dict, name: str) -> float:
    return rec.get("host_ms", {}).get(name, 0.0)


def per_mbp(rec: dict, ms: float | None, needs: str) -> float | None:
    """``ms`` over the read Mbp, where the range ``needs`` was entered."""
    if ms is None or needs not in rec.get("host_ms", {}):
        return None
    return ms / rec["mbp"]


def range_per_mbp(rec: dict, names: tuple[str, ...], needs: str):
    """Host ms in the ranges ``names`` a read Mbp (0 where none of them
    was entered but ``needs`` was)."""
    return per_mbp(rec, sum(host_ms(rec, n) for n in names), needs)


def kernel_per_mbp(rec: dict, needs: str):
    if "kernel_ms" not in rec:
        return None
    return per_mbp(rec, sum(rec["kernel_ms"].values()), needs)


def myers_roofline(rec: dict):
    """B4's bound over its event time, in %."""
    if not rec.get("myers"):
        return None
    bound, spent = rec["myers"]
    return 100.0 * bound / spent


def device_idle(rec: dict):
    """The share of the traced window in which no device operation ran,
    in %."""
    if "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def peak_gib(rec: dict):
    return rec["peak_bytes"] / 2**30 if rec.get("peak_bytes") else None
