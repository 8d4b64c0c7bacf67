"""``cli correct``: all-vs-all map, ``banded-escalate`` alignment of every
query-side overlap, pileup windows, POA polish
(``claragenomicsanalysis_tpu_torch.models.correct.correct_reads``).

The entry returns the mapper's overlaps as ``correct_reads`` mapped them
(``CorrectResult.rows``, (8, n) rows in canonical order) beside the
corrected reads; it adds no work to the job."""

from ..reference.judge import judge_correct as judge  # noqa: F401


def run(parser, settings: dict, device) -> dict:
    from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                             MapperConfig)
    from claragenomicsanalysis_tpu_torch.models.correct import correct_reads
    cfg = CorrectConfig(
        mapper=MapperConfig(**settings["mapper"]),
        window_length=settings["window_length"],
        max_support=settings["max_support"],
        min_matched_bases=settings["min_matched_bases"],
        aligner_band_radius=settings["aligner_band_radius"],
        max_alignment_length=settings["max_alignment_length"],
        min_supports_for_poa=settings["min_supports_for_poa"],
        poa_backend=settings["poa_backend"])
    res = correct_reads(parser, cfg, device=device)
    return {"seqs": res.seqs, "rows": res.rows.T,
            "attempted": res.n_polished + res.n_window_failed,
            "failed": res.n_window_failed}
