"""The port's Hirschberg–Myers aligner (claragenomicsanalysis_tpu_torch/align/
hirschberg.py) against the JAX package's ``align.hirschberg`` (XLA kind) and
the NW oracle.  Paths and distances are compared exactly."""

import numpy as np
import torch

from claragenomicsanalysis_tpu.align.hirschberg import (
    hirschberg_align_batch as jax_hirschberg)
from claragenomicsanalysis_tpu.core.config import AlignerConfig
from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.align import hirschberg


def pairs_with_ties(seed: int) -> list[tuple[str, str]]:
    """Random pairs that split several levels deep, identical and empty
    pairs, and repeats, whose middle rows have many optimal crossing
    columns (the smallest-column rule decides)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for n in (70, 150, 260):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a, int(rng.integers(3, 25)), rng)))
    pairs += [("ACGT" * 40, "ACGT" * 40), ("", "ACGT"), ("ACGTA", ""),
              ("", ""), ("AC" * 45, "AC" * 40), ("A" * 80, "A" * 66),
              ("ACGTT" * 20, "ACGT" * 22), ("ACNNGT" * 10, "ACGT" * 13)]
    return pairs


def port(pairs, device="cpu"):
    return hirschberg.hirschberg_align_batch([a for a, _ in pairs],
                                             [b for _, b in pairs], device)


def test_matches_jax_hirschberg():
    pairs = pairs_with_ties(3)
    cfg = AlignerConfig(512, 512, len(pairs))
    j_paths, j_dists, _ = jax_hirschberg([a for a, _ in pairs],
                                         [b for _, b in pairs], cfg,
                                         backend="xla")
    paths, dists = port(pairs)
    assert paths == j_paths
    np.testing.assert_array_equal(dists, j_dists)
    for (a, b), p, d in zip(pairs, paths, dists):
        assert d == nw_oracle.align(a, b)[1]          # optimal
        assert sum(s in (0, 1, 2) for s in p) == len(a)
        assert sum(s in (0, 1, 3) for s in p) == len(b)
    assert paths[3] == [0] * 160 and paths[4] == [3] * 4
    assert paths[5] == [2] * 5 and paths[6] == []


def test_tie_case_pins_the_smallest_column(monkeypatch):
    """The repeats have splits with several optimal columns: taking the
    largest one instead gives other (equally optimal) paths, so the parity
    above holds only under the smallest-column rule."""
    pairs = pairs_with_ties(3)[-4:]
    want, want_d = port(pairs)

    def largest_column(rows, tlen):
        n = rows.shape[0] // 2
        fwd, rev = rows[:n].long(), rows[n:].long()
        mlen = tlen[:n].long()[:, None]
        jj = torch.arange(rows.shape[1])[None, :]
        rev_at = rev.gather(1, (mlen - jj).clamp(0, rows.shape[1] - 1))
        total = torch.where(jj <= mlen, fwd + rev_at, 2**30)
        best = total.min(1, keepdim=True).values
        return torch.where(total == best, jj, -1).max(1).values

    monkeypatch.setattr(hirschberg, "split_points", largest_column)
    other, other_d = port(pairs)
    np.testing.assert_array_equal(other_d, want_d)
    assert other != want


def test_split_points_break_ties_to_smallest_column():
    fwd = torch.tensor([[0, 1, 2, 3, 4], [2, 1, 1, 2, 0]], dtype=torch.int32)
    rev = torch.tensor([[0, 1, 2, 3, 4], [3, 1, 1, 2, 0]], dtype=torch.int32)
    tlen = torch.tensor([4, 3, 4, 3], dtype=torch.int32)
    # row 0: every column sums to 4; row 1 (mlen 3): 4, 2, 2, 5, and
    # column 4 lies past mlen
    got = hirschberg.split_points(torch.cat([fwd, rev]), tlen)
    assert got.tolist() == [0, 1]


def test_pow2_at_least():
    x = np.array([1, 2, 3, 4, 5, 31, 32, 33, 1000])
    assert hirschberg.pow2_at_least(x).tolist() == [
        1 << (int(v) - 1).bit_length() for v in x]
