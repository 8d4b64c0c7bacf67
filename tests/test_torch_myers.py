"""The port's Myers bit-vector bottom rows (claragenomicsanalysis_tpu_torch/
ops/myers.py) against the JAX package's ``ops.myers.myers_bottom_row`` and
the NW oracle, on numpy-seeded inputs.  Integer DP: every comparison is
exact (tolerance 0), on the whole ``rows`` array, columns past ``tlen``
included."""

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.ops.myers import myers_bottom_row as jax_myers
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.ops import myers
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs

LQ, LT = 200, 216        # padded shapes of the edge batch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def edge_pairs(seed: int) -> list[tuple[str, str]]:
    """Query lengths at the 32-base word boundaries and a few random ones,
    each against a mutated copy, plus empty sides, N-rich pairs (N never
    matches) and a target that ends long before the padded width."""
    rng = np.random.default_rng(seed)
    pairs = []
    for n in (1, 31, 32, 33, 64, 65, 96, 150, LQ):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a, int(rng.integers(0, 12)),
                                         rng)[:LT]))
    a = generate_random_genome(120, rng)
    n_rich = a[:40] + "N" * 20 + a[60:]
    pairs += [("", "ACGTACGT"), ("ACGTAC", ""), ("", ""),
              (n_rich, n_rich), ("NNNN", "NNNN"), (a, a[:7])]
    return pairs


def tensors(pairs, device="cpu"):
    arrays = pack_pairs([a for a, _ in pairs], [b for _, b in pairs], LQ, LT)
    return arrays, tuple(torch.from_numpy(x).to(device) for x in arrays)


def test_plain_version_matches_jax_myers():
    pairs = edge_pairs(5)
    arrays, args = tensors(pairs)
    rows, scores = myers.myers_bottom_row_torch(*args)
    j_rows, j_scores = jax_myers(*arrays)
    assert rows.dtype == scores.dtype == torch.int32
    assert rows.shape == (len(pairs), LT + 1)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(j_scores))


@pytest.mark.parametrize("qlen", [31, 32, 33, 64, 65])
def test_word_boundaries_match_oracle(qlen):
    """Bottom rows at the query word boundaries equal the dense DP's last
    row; the columns past tlen continue over PAD targets (no matches)."""
    rng = np.random.default_rng(qlen)
    a = generate_random_genome(qlen, rng)
    pairs = [(a, mutate_sequence(a, 6, rng)), (a, a), (a, "")]
    _, args = tensors(pairs)
    rows, scores = myers.myers_bottom_row(*args)
    for b, (x, y) in enumerate(pairs):
        D = nw_oracle.nw_matrix(x, y + "N" * (LT - len(y)))
        np.testing.assert_array_equal(rows[b].numpy(), D[len(x)])
        assert int(scores[b]) == D[len(x), len(y)]


def test_empty_query_row_counts_columns():
    _, args = tensors([("", "ACG"), ("", "")])
    rows, scores = myers.myers_bottom_row_torch(*args)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.tile(np.arange(LT + 1), (2, 1)))
    assert scores.tolist() == [3, 0]


def test_wrapper_runs_plain_version_for_cpu_tensors():
    _, args = tensors(edge_pairs(6))
    with profiling.stage_times() as st:
        got = myers.myers_bottom_row(*args)
    want = myers.myers_bottom_row_torch(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert st.launches() == {}


def test_rejects_bad_inputs():
    q = torch.zeros((2, 8), dtype=torch.int8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        myers.myers_bottom_row(q.long(), lens, q, lens)
    with pytest.raises(ValueError):
        myers.myers_bottom_row(q, lens.long(), q, lens)
    with pytest.raises(ValueError):
        myers.myers_bottom_row(q, lens[:1], q, lens)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    rng = np.random.default_rng(7)
    pairs = edge_pairs(7)
    for _ in range(8):              # 1-2 kb, several words a thread
        a = generate_random_genome(int(rng.integers(1000, 2001)), rng)
        pairs.append((a, mutate_sequence(a, 80, rng)))
    arrays = pack_pairs([a for a, _ in pairs], [b for _, b in pairs],
                        2048, 2200)
    args = tuple(torch.from_numpy(x).to(cuda_device) for x in arrays)
    with profiling.stage_times() as st:
        rows_k, scores_k = myers.myers_bottom_row(*args)
        torch.cuda.synchronize()
    assert st.launches() == {"myers": 1}
    rows_p, scores_p = myers.myers_bottom_row_torch(*args)
    assert torch.equal(rows_k, rows_p)
    assert torch.equal(scores_k, scores_p)


@pytest.mark.cuda
def test_longest_query_matches_plain_version_on_card(cuda_device):
    """The first design's top end, 4,096 words a block, and one word more:
    the kernel now runs such queries in passes of 512 words, each equal to
    the plain version, and refuses no length."""
    rng = np.random.default_rng(8)
    Lq = 4096 * myers.WORD
    a = generate_random_genome(Lq + myers.WORD, rng)
    pairs = [(a[:Lq], mutate_sequence(a[:600], 30, rng)),
             (a[:100_001], mutate_sequence(a[-500:], 20, rng))]
    for lq in (Lq, Lq + 1):
        arrays = pack_pairs([x for x, _ in pairs], [y for _, y in pairs],
                            lq, 640)
        args = tuple(torch.from_numpy(x).to(cuda_device) for x in arrays)
        rows_k, scores_k = myers.myers_bottom_row(*args)
        torch.cuda.synchronize()
        rows_p, scores_p = myers.myers_bottom_row_torch(*args)
        assert torch.equal(rows_k, rows_p)
        assert torch.equal(scores_k, scores_p)
