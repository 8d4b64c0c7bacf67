"""``cli pipeline``: all-vs-all map, ``myers`` alignment of every overlap,
PAF rows with ``cg:Z`` CIGARs
(``claragenomicsanalysis_tpu_torch.models.pipeline.run_pipeline``)."""

from ..reference.judge import judge_pipeline as judge  # noqa: F401
from . import rows_of


def run(parser, settings: dict, device) -> dict:
    from claragenomicsanalysis_tpu_torch.core.config import (MapperConfig,
                                                             PipelineConfig)
    from claragenomicsanalysis_tpu_torch.models.pipeline import run_pipeline
    cfg = PipelineConfig(
        mapper=MapperConfig(**settings["mapper"]),
        aligner_band_radius=settings["aligner_band_radius"],
        max_alignment_length=settings["max_alignment_length"])
    res = run_pipeline(parser, cfg, device=device)
    return {"rows": rows_of(res.overlaps),
            "cigars": [o.cigar for o in res.overlaps],
            "attempted": res.n_aligned + res.n_align_failed,
            "failed": res.n_align_failed}
