"""The port's row-layout banded NW (claragenomicsanalysis_tpu_torch/ops/
nw_row.py, B3) and its traceback decode (ops/tb_decode.py ``decode_row``,
B2's row layout) against the JAX package's row kernel and decoder, the NW
oracle and the port's own diag kernel, on the same numpy-seeded inputs.

The DP is integer work, so every comparison is exact (tolerance 0).  Paths
are compared only where the score is finite: a problem whose band overflows
gets a status and no path, and its walk over unreachable cells is not
defined."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.cpu import nw_oracle
from claragenomicsanalysis_tpu.ops import nw_band
from claragenomicsanalysis_tpu.ops.nw_band_pallas import banded_nw_pallas
from claragenomicsanalysis_tpu.ops.tb_decode_pallas import _decode
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.ops import nw_diag, nw_row, tb_decode
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.ops.convert import (from_reference,
                                                         to_reference)

INF = nw_row.INF
LQ, LT = 72, 56          # asymmetric padded shapes, as the diag tests


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_pairs(seed: int, r: int, lq: int = LQ, lt: int = LT):
    """Random mutated pairs plus the edge rows: N bases (never match, not
    even each other), empty sequences, and a pair outside the band."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(6):
        a = generate_random_genome(int(rng.integers(1, lq)), rng)
        b = mutate_sequence(a, int(rng.integers(0, min(r, 40) + 3)),
                            rng)[:lt]
        pairs.append((a, b))
    pairs += [("ACNNGTNA", "ACNNGTTA"), ("", "ACG"), ("ACG", ""), ("", ""),
              ("A" * min(r + 3, lq), "A")]
    return pairs


def pack(pairs, lq: int = LQ, lt: int = LT):
    q = np.stack([encode(a, lq) for a, _ in pairs])
    t = np.stack([encode(b, lt) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    tlen = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return q, qlen, t, tlen


def finite(scores) -> list[int]:
    return [b for b, s in enumerate(np.asarray(scores)) if s < INF]


def reached_rows_equal(tb_a, tb_b, qlen) -> None:
    """The two tracebacks agree on every packed row a problem reaches
    (rows past round_up(qlen, 4) are the port's zeros)."""
    for b, n in enumerate(np.asarray(qlen)):
        np.testing.assert_array_equal(tb_a[: (n + 3) // 4, b],
                                      tb_b[: (n + 3) // 4, b], err_msg=b)


@pytest.mark.parametrize("r", [3, 8, 31])
def test_matches_jax_row_kernel(r):
    pairs = make_pairs(400 + r, r)
    q, qlen, t, tlen = pack(pairs)
    s_jax, tb_jax = banded_nw_pallas(q, qlen, t, tlen, r, interpret=True)
    s_jax, tb_jax = np.asarray(s_jax), np.asarray(tb_jax)

    qt, qlt, tt, tlt, _ = from_reference(q, qlen, t, tlen)
    s_port, tb_port = nw_row.banded_nw_row_torch(qt, qlt, tt, tlt, r)
    tb_port_np = to_reference(qt, qlt, tt, tlt, tb_port)[4]

    np.testing.assert_array_equal(s_port.numpy(), s_jax)
    assert s_jax[-1] == INF                      # the out-of-band row
    assert tb_port_np.shape == tb_jax.shape
    reached_rows_equal(tb_port_np, tb_jax, qlen)
    decode = dict(packed=True, use_native="never")
    p_jax = nw_band.traceback_paths(tb_jax, qlen, tlen, r, **decode)
    # the port's traceback through the JAX package's decoder, and the port's
    # device decoder (plain version on CPU)
    p_cross = nw_band.traceback_paths(tb_port_np, qlen, tlen, r, **decode)
    p_port = tb_decode.traceback_paths_device(tb_port, qlt, tlt, r, "row")
    ok = finite(s_jax)
    assert len(ok) >= 6
    for b in ok:
        assert p_port[b] == p_jax[b] == p_cross[b], b
        want_path, want_dist, _ = nw_oracle.align(*pairs[b], band_radius=r)
        assert (p_port[b], int(s_port[b])) == (want_path, want_dist), b


def check_against_oracle_and_diag(pairs, r, lq=LQ, lt=LT):
    """Scores and paths of the plain row version equal nw_oracle's banded
    alignment and the port's diag kernel (plain version), statuses
    included."""
    q, qlen, t, tlen = from_reference(*pack(pairs, lq, lt))[:4]
    s_row, tb_row = nw_row.banded_nw_row_torch(q, qlen, t, tlen, r)
    assert tb_row.shape == (nw_row.tb_rows(lq), len(pairs),
                            nw_row.band_width_row(r))
    s_diag, tb_diag = nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, r)
    assert torch.equal(s_row, s_diag)
    p_row = tb_decode.traceback_paths_device(tb_row, qlen, tlen, r, "row")
    p_diag = tb_decode.traceback_paths_device(tb_diag, qlen, tlen, r, "diag")
    for b, (a, c) in enumerate(pairs):
        path, dist, status = nw_oracle.align(a, c, band_radius=r)
        assert (int(s_row[b]) < INF) == (status == StatusType.SUCCESS), b
        if status == StatusType.SUCCESS:
            assert (p_row[b], int(s_row[b])) == (path, dist), b
            assert p_row[b] == p_diag[b], b
    return s_row


@pytest.mark.parametrize("r", [1, 2, 4, 16, 64])
def test_plain_version_matches_oracle(r):
    scores = check_against_oracle_and_diag(make_pairs(500 + r, r), r)
    assert int(scores[-1]) == INF                # the out-of-band row


def test_wide_band_matches_oracle():
    """W = 1,208 band lanes, more than a block's 1,024 threads, on short
    pairs with many edits (the shape of banded-escalate's widened bands)."""
    r = 600
    assert nw_row.band_width_row(r) > 1024
    rng = np.random.default_rng(7)
    pairs = []
    for n in (40, 150, 290):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a, n // 3, rng)[:300]))
    pairs += [("A" * 290, "C" * 10), ("", "ACGT" * 70), ("", "")]
    scores = check_against_oracle_and_diag(pairs, r, 296, 304)
    assert (scores < INF).all()


@pytest.mark.parametrize("r", [3, 31])
def test_decode_row_matches_jax_decoder_on_jax_traceback(r):
    q, qlen, t, tlen = pack(make_pairs(600 + r, r))
    s_jax, tb_jax = banded_nw_pallas(q, qlen, t, tlen, r, interpret=True)
    packed_jax, start_jax = _decode(tb_jax, jnp.asarray(qlen),
                                    jnp.asarray(tlen), band_radius=r,
                                    interpret=True, diag=False)
    packed_jax, start_jax = np.asarray(packed_jax), np.asarray(start_jax)

    _, qlt, _, tlt, tbt = from_reference(q, qlen, t, tlen, np.asarray(tb_jax))
    packed, start = tb_decode.decode_row_torch(tbt, qlt, tlt, r)
    assert packed.shape == packed_jax.shape and packed.dtype == torch.int32
    assert packed.shape[1] * 16 == tb_decode.path_slots_row(tbt.shape[0], r)
    ok = np.asarray(s_jax) < INF
    assert ok.sum() >= 8 and not ok[-1]
    np.testing.assert_array_equal(packed.numpy()[ok], packed_jax[ok])
    np.testing.assert_array_equal(start.numpy()[ok], start_jax[ok])


def test_nw_wrapper_runs_plain_version_for_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; packed rows past a problem's last one are zero."""
    q, qlen, t, tlen = from_reference(*pack(make_pairs(7, 8)))[:4]
    with profiling.stage_times() as st:
        s_w, tb_w = nw_row.banded_nw_row(q, qlen, t, tlen, 8)
    s_p, tb_p = nw_row.banded_nw_row_torch(q, qlen, t, tlen, 8)
    assert torch.equal(s_w, s_p) and torch.equal(tb_w, tb_p)
    assert st.launches() == {}
    assert tb_w.shape == (nw_row.tb_rows(LQ), len(qlen),
                          nw_row.band_width_row(8))
    for b in range(len(qlen)):
        assert not tb_w[(int(qlen[b]) + 3) // 4:, b].any(), b
        if qlen[b] > 0:
            assert tb_w[(int(qlen[b]) - 1) // 4, b].any(), b


def test_decode_wrapper_runs_plain_version_for_cpu_tensors():
    q, qlen, t, tlen = from_reference(*pack(make_pairs(8, 8)))[:4]
    _, tb = nw_row.banded_nw_row(q, qlen, t, tlen, 8)
    with profiling.stage_times() as st:
        got = tb_decode.decode_row(tb, qlen, tlen, 8)
    want = tb_decode.decode_row_torch(tb, qlen, tlen, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert st.launches() == {}


def test_rejects_bad_inputs_and_unknown_layout():
    q = torch.zeros((2, 8), dtype=torch.int8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        nw_row.banded_nw_row(q.long(), lens, q, lens, 4)
    with pytest.raises(ValueError):
        nw_row.banded_nw_row(q, lens.long(), q, lens, 4)
    with pytest.raises(ValueError):
        nw_row.banded_nw_row(q, lens, q, lens, -1)
    _, tb = nw_row.banded_nw_row(q, lens, q, lens, 4)
    with pytest.raises(ValueError, match="layout"):
        tb_decode.traceback_paths_device(tb, lens, lens, 4, "anti-diagonal")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    """B3 and B2's row layout against their plain versions, every byte of
    the traceback and every packed word of the finite rows, at radii whose
    bands take 1, 2 and 8 lanes a thread."""
    for r, lq, lt in ((1, LQ, LT), (3, LQ, LT), (8, LQ, LT), (31, LQ, LT),
                      (64, LQ, LT), (600, 296, 304), (2100, 200, 208)):
        pairs = make_pairs(700 + r, r, lq, lt)
        q, qlen, t, tlen = from_reference(*pack(pairs, lq, lt),
                                          device=cuda_device)[:4]
        with profiling.stage_times() as st:
            s_k, tb_k = nw_row.banded_nw_row(q, qlen, t, tlen, r)
            pk_k, st_k = tb_decode.decode_row(tb_k, qlen, tlen, r)
            torch.cuda.synchronize()
        assert st.launches() == {"nw_row": 1, "tb_decode_row": 1}
        s_p, tb_p = nw_row.banded_nw_row_torch(q, qlen, t, tlen, r)
        assert torch.equal(s_k, s_p), r
        assert torch.equal(tb_k, tb_p), r
        pk_p, st_p = tb_decode.decode_row_torch(tb_k, qlen, tlen, r)
        ok = s_k < INF
        assert torch.equal(pk_k[ok], pk_p[ok]), r
        assert torch.equal(st_k[ok], st_p[ok]), r
