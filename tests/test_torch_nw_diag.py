"""The port's anti-diagonal banded NW (claragenomicsanalysis_tpu_torch/ops/
nw_diag.py) against the JAX package on the same numpy-seeded inputs.

The DP is integer work, so every comparison is exact (tolerance 0).  Paths
are compared only where the score is finite: a problem whose band overflows
gets a status and no path, and its walk over unreachable cells is not
defined."""

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.ops import nw_band
from claragenomicsanalysis_tpu.ops.nw_diag_pallas import (
    banded_nw_diag_pallas, traceback_paths_diag as jax_traceback_paths_diag)
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.ops import nw_diag
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.ops.convert import (from_reference,
                                                         to_reference)

INF = nw_diag.INF
LQ, LT = 72, 56          # asymmetric padded shapes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_pairs(seed: int, r: int) -> list[tuple[str, str]]:
    """Random mutated pairs plus the edge rows: N bases (never match, not
    even each other), empty sequences, and a pair outside the band."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(6):
        a = generate_random_genome(int(rng.integers(1, LQ)), rng)
        b = mutate_sequence(a, int(rng.integers(0, r + 3)), rng)[:LT]
        pairs.append((a, b))
    pairs += [("ACNNGTNA", "ACNNGTTA"), ("", "ACG"), ("ACG", ""), ("", ""),
              ("A" * (r + 3), "A")]
    return pairs


def pack(pairs):
    q = np.stack([encode(a, LQ) for a, _ in pairs])
    t = np.stack([encode(b, LT) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    tlen = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return q, qlen, t, tlen


def finite(scores) -> list[int]:
    return [b for b, s in enumerate(np.asarray(scores)) if s < INF]


@pytest.mark.parametrize("r", [4, 8, 31])
def test_matches_jax_diag_kernel(r):
    pairs = make_pairs(100 + r, r)
    q, qlen, t, tlen = pack(pairs)
    s_jax, tb_jax = banded_nw_diag_pallas(q, qlen, t, tlen, r, interpret=True)
    s_jax, tb_jax = np.asarray(s_jax), np.asarray(tb_jax)

    qt, qlt, tt, tlt, _ = from_reference(q, qlen, t, tlen)
    s_port, tb_port = nw_diag.banded_nw_diag_torch(qt, qlt, tt, tlt, r)
    _, _, _, _, tb_port_np = to_reference(qt, qlt, tt, tlt, tb_port)

    np.testing.assert_array_equal(s_port.numpy(), s_jax)
    assert s_jax[-1] == INF                      # the out-of-band row
    assert tb_port_np.shape == tb_jax.shape
    p_jax = jax_traceback_paths_diag(tb_jax, qlen, tlen, r)
    p_port = nw_diag.traceback_paths_diag(tb_port_np, qlen, tlen, r)
    # the port's traceback through the JAX package's decoder
    p_cross = jax_traceback_paths_diag(tb_port_np, qlen, tlen, r)
    ok = finite(s_jax)
    assert len(ok) >= 6
    for b in ok:
        assert p_port[b] == p_jax[b] == p_cross[b], b
        want_path, want_dist, _ = nw_oracle.align(*pairs[b], band_radius=r)
        assert (p_port[b], int(s_port[b])) == (want_path, want_dist), b


@pytest.mark.parametrize("r", [1, 2, 3])
def test_small_radii_match_xla_scan(r):
    """The port sends r < 4 to the same anti-diagonal kernel; the JAX
    package's XLA scan twin and its host decoder define the result."""
    pairs = make_pairs(200 + r, r)
    q, qlen, t, tlen = pack(pairs)
    s_scan, tb_scan = nw_band.banded_nw(q, qlen, t, tlen, r)
    s_scan = np.asarray(s_scan)
    p_scan = nw_band.traceback_paths(np.asarray(tb_scan), qlen, tlen, r,
                                     use_native="never")
    qt, qlt, tt, tlt, _ = from_reference(q, qlen, t, tlen)
    s_port, tb_port = nw_diag.banded_nw_diag_torch(qt, qlt, tt, tlt, r)
    np.testing.assert_array_equal(s_port.numpy(), s_scan)
    p_port = nw_diag.traceback_paths_diag(tb_port.numpy(), qlen, tlen, r)
    for b in finite(s_scan):
        assert p_port[b] == p_scan[b], b


def test_wrapper_runs_plain_version_for_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; rows past a problem's last diagonal are zero."""
    q, qlen, t, tlen = from_reference(*pack(make_pairs(7, 8)))[:4]
    with profiling.stage_times() as st:
        s_w, tb_w = nw_diag.banded_nw_diag(q, qlen, t, tlen, 8)
    s_p, tb_p = nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, 8)
    assert torch.equal(s_w, s_p) and torch.equal(tb_w, tb_p)
    assert st.launches() == {}
    assert tb_w.shape == (nw_diag.padded_diagonals(LQ, LT) // 4, len(qlen),
                          nw_diag.band_slots(8))
    last_row = (qlen + tlen) // 4
    for b in range(len(qlen)):
        assert not tb_w[int(last_row[b]) + 1:, b].any(), b


def test_rejects_bad_inputs():
    q = torch.zeros((2, 8), dtype=torch.int8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        nw_diag.banded_nw_diag(q.long(), lens, q, lens, 4)
    with pytest.raises(ValueError):
        nw_diag.banded_nw_diag(q, lens.long(), q, lens, 4)
    with pytest.raises(ValueError):
        nw_diag.banded_nw_diag(q, lens, q, lens, -1)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    for r in (3, 8, 31, 64):
        q, qlen, t, tlen = from_reference(*pack(make_pairs(300 + r, r)),
                                          device=cuda_device)[:4]
        with profiling.stage_times() as st:
            s_k, tb_k = nw_diag.banded_nw_diag(q, qlen, t, tlen, r)
            torch.cuda.synchronize()
        assert st.launches() == {"nw_diag": 1}
        s_p, tb_p = nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, r)
        assert torch.equal(s_k, s_p), r
        assert torch.equal(tb_k, tb_p), r
