"""The port's traceback decoder (claragenomicsanalysis_tpu_torch/ops/
tb_decode.py) against the JAX package's on-device decoder, and the array
conversion between the packages (ops/convert.py).

Tracebacks are fed across in both directions: the JAX kernel's tb through the
port's decoder, and the port's tb through the JAX package's decoder.  Outputs
are integer arrays, compared exactly on every problem with a finite score."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.ops.nw_diag_pallas import (
    banded_nw_diag_pallas, traceback_paths_diag as jax_traceback_paths_diag)
from claragenomicsanalysis_tpu.ops.tb_decode_pallas import _decode
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.ops import nw_diag, tb_decode
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.ops.convert import (from_reference,
                                                         to_reference)

INF = nw_diag.INF
R = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_batch(seed: int, L: int = 64):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(7):
        a = generate_random_genome(int(rng.integers(1, L)), rng)
        b = mutate_sequence(a, int(rng.integers(0, R)), rng)[:L]
        pairs.append((a, b))
    # deletion tail at row 0, insertion column, empty, N, out of band
    pairs += [("", "ACG"), ("ACG", ""), ("", ""), ("ANNA", "ANNA"),
              ("A" * 40, "A" * 3)]
    q = np.stack([encode(a, L) for a, _ in pairs])
    t = np.stack([encode(b, L) for _, b in pairs])
    qlen = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    tlen = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return q, qlen, t, tlen


def test_decode_matches_jax_decoder_on_jax_traceback():
    q, qlen, t, tlen = make_batch(11)
    s_jax, tb_jax = banded_nw_diag_pallas(q, qlen, t, tlen, R, interpret=True)
    packed_jax, start_jax = _decode(tb_jax, jnp.asarray(qlen),
                                    jnp.asarray(tlen), band_radius=R,
                                    interpret=True, diag=True)
    packed_jax, start_jax = np.asarray(packed_jax), np.asarray(start_jax)

    _, qlt, _, tlt, tbt = from_reference(q, qlen, t, tlen, np.asarray(tb_jax))
    packed, start = tb_decode.decode_diag_torch(tbt, qlt, tlt, R)
    assert packed.shape == packed_jax.shape and packed.dtype == torch.int32
    ok = np.asarray(s_jax) < INF
    assert ok.sum() >= 10 and not ok[-1]
    np.testing.assert_array_equal(packed.numpy()[ok], packed_jax[ok])
    np.testing.assert_array_equal(start.numpy()[ok], start_jax[ok])


def test_paths_of_port_traceback_match_jax_host_decoder():
    q, qlen, t, tlen = make_batch(12)
    qt, qlt, tt, tlt, _ = from_reference(q, qlen, t, tlen)
    scores, tb = nw_diag.banded_nw_diag_torch(qt, qlt, tt, tlt, R)
    dev_paths = tb_decode.traceback_paths_device(tb, qlt, tlt, R)
    tb_np = to_reference(qt, qlt, tt, tlt, tb)[4]
    jax_paths = jax_traceback_paths_diag(tb_np, qlen, tlen, R)
    host_paths = nw_diag.traceback_paths_diag(tb_np, qlen, tlen, R)
    for b, s in enumerate(scores.tolist()):
        if s < INF:
            assert dev_paths[b] == jax_paths[b] == host_paths[b], b
            assert sum(c != 0 for c in dev_paths[b]) == s, b


def test_wrapper_runs_plain_version_for_cpu_tensors():
    q, qlen, t, tlen = from_reference(*make_batch(13))[:4]
    _, tb = nw_diag.banded_nw_diag(q, qlen, t, tlen, R)
    with profiling.stage_times() as st:
        got = tb_decode.decode_diag(tb, qlen, tlen, R)
    want = tb_decode.decode_diag_torch(tb, qlen, tlen, R)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert st.launches() == {}


def test_convert_round_trip_and_checks():
    arrays = make_batch(14)
    tb = np.arange(4 * len(arrays[1]) * 8, dtype=np.int64).astype(
        np.int8).reshape(4, len(arrays[1]), 8)
    back = to_reference(*from_reference(*arrays, tb))
    for a, b in zip((*arrays, tb), back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    q, qlen, t, tlen = arrays
    with pytest.raises(ValueError):                  # wrong dtype
        from_reference(q.astype(np.int32), qlen, t, tlen)
    with pytest.raises(ValueError):                  # batch mismatch
        from_reference(q, qlen[:-1], t, tlen)
    with pytest.raises(ValueError):                  # tb batch mismatch
        from_reference(q, qlen, t, tlen, tb[:, :-1])


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    q, qlen, t, tlen = from_reference(*make_batch(15), device=cuda_device)[:4]
    scores, tb = nw_diag.banded_nw_diag(q, qlen, t, tlen, R)
    with profiling.stage_times() as st:
        packed, start = tb_decode.decode_diag(tb, qlen, tlen, R)
        torch.cuda.synchronize()
    assert st.launches() == {"tb_decode": 1}
    want_packed, want_start = tb_decode.decode_diag_torch(tb, qlen, tlen, R)
    ok = scores < INF
    assert torch.equal(packed[ok], want_packed[ok])
    assert torch.equal(start[ok], want_start[ok])
