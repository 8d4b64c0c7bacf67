"""``cli correct``: all-vs-all map, ``banded-escalate`` alignment of every
query-side overlap, pileup windows, POA polish
(``claragenomicsanalysis_tpu_torch.models.correct.correct_reads``).

The overlaps that ``correct_reads`` mapped are kept as its mapper returned
them, (8, n) rows in canonical order; the entry adds no work to the job
but a reference to them."""

from ..reference.judge import judge_correct as judge  # noqa: F401


def run(parser, settings: dict, device) -> dict:
    from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                             MapperConfig)
    from claragenomicsanalysis_tpu_torch.models import correct
    cfg = CorrectConfig(
        mapper=MapperConfig(**settings["mapper"]),
        window_length=settings["window_length"],
        max_support=settings["max_support"],
        min_matched_bases=settings["min_matched_bases"],
        aligner_band_radius=settings["aligner_band_radius"],
        max_alignment_length=settings["max_alignment_length"],
        min_supports_for_poa=settings["min_supports_for_poa"],
        poa_backend=settings["poa_backend"])
    mapped = []
    port_map = correct.map_all_vs_all

    def keep(*args, **kwargs):
        res = port_map(*args, **kwargs)
        mapped.append(res)
        return res

    correct.map_all_vs_all = keep
    try:
        res = correct.correct_reads(parser, cfg, device=device)
    finally:
        correct.map_all_vs_all = port_map
    return {"seqs": res.seqs, "rows": mapped[0].rows.T,
            "attempted": res.n_polished + res.n_window_failed,
            "failed": res.n_window_failed}

