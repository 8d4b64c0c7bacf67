"""``cli correct -d N`` on one node: N ranks, one a card (NCCL; gloo on
the CPU), matching on 'rep' and the reads dealt over 'data', as
``cli correct -d N`` lays them out
(``claragenomicsanalysis_tpu_torch.models.correct.correct_reads(...,
mesh=make_mesh(data=N))`` on every rank).

The ranks are a ``parallel.multihost.RankPool`` started at the first
``run`` and kept for the process (the caller is rank 0; :func:`close`, or
the interpreter's exit, ends it).  ``run`` returns rank 0's result, as
``entries/correct.py`` returns its own: the corrected reads, the mapper's
overlaps (``CorrectResult.rows``), ``attempted`` and ``failed``."""

from claragenomicsanalysis_tpu_torch.parallel.multihost import RankPool

from ..reference import judge as reference
from ..reference.judge import judge_correct as judge

# the harness looks a configuration's judge up by its entry's name there
reference.JUDGES["correct_ranks"] = judge

_pool = None


def run(parser, settings: dict, device) -> dict:
    global _pool
    n = settings["devices"]
    if _pool is None:
        devices = ([f"cuda:{r}" for r in range(n)] if device == "cuda"
                   else ["cpu"] * n)
        _pool = RankPool(n, devices, log_level="WARNING")
    return _pool.run(rank_job, parser, settings, device)


def rank_job(parser, settings: dict, device) -> dict:
    """One rank's part of a job: the whole correction on the rank's mesh;
    every rank returns every corrected read."""
    from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                             MapperConfig)
    from claragenomicsanalysis_tpu_torch.models.correct import correct_reads
    from claragenomicsanalysis_tpu_torch.parallel.mesh import make_mesh
    cfg = CorrectConfig(
        mapper=MapperConfig(**settings["mapper"]),
        window_length=settings["window_length"],
        max_support=settings["max_support"],
        min_matched_bases=settings["min_matched_bases"],
        aligner_band_radius=settings["aligner_band_radius"],
        max_alignment_length=settings["max_alignment_length"],
        min_supports_for_poa=settings["min_supports_for_poa"],
        poa_backend=settings["poa_backend"])
    res = correct_reads(parser, cfg, device=device,
                        mesh=make_mesh(data=settings["devices"]))
    return {"seqs": res.seqs, "rows": res.rows.T,
            "attempted": res.n_polished + res.n_window_failed,
            "failed": res.n_window_failed}


def close() -> None:
    """End the pool and reap its ranks (the next ``run`` starts another)."""
    global _pool
    if _pool is not None:
        _pool.close()
        _pool = None
