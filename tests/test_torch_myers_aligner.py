"""The port's ``myers`` and ``banded-escalate`` batch aligners
(claragenomicsanalysis_tpu_torch/align/myers_aligner.py) against the JAX
package's (``backend="xla"``), and the routing rule between the banded
re-run and Hirschberg.  Paths and distances are compared exactly."""

import numpy as np
import pytest

from claragenomicsanalysis_tpu.align import myers_aligner as jax_ma
from claragenomicsanalysis_tpu.core.config import AlignerConfig
from claragenomicsanalysis_tpu.models.aligner import (
    create_aligner as jax_create_aligner)
from claragenomicsanalysis_tpu.utils.genomeutils import (
    generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.align import myers_aligner
from claragenomicsanalysis_tpu_torch.models import aligner as port_aligner
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs

ALGORITHMS = {"myers": "myers_align_batch",
              "banded-escalate": "banded_escalate_align_batch"}


def short_pairs(seed: int) -> list[tuple[str, str]]:
    """Pairs of 20-300 bases at 0-15 % edits, a wide length difference,
    identical, empty and N-rich pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(7):
        a = generate_random_genome(int(rng.integers(20, 300)), rng)
        pairs.append((a, mutate_sequence(
            a, int(rng.integers(0, 0.15 * len(a) + 1)), rng)))
    a = generate_random_genome(200, rng)
    pairs += [(a, a[:60]), (a, a), ("", "ACGT"), ("", ""),
              (a[:50] + "N" * 10 + a[60:], a)]
    return pairs


@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_batch_aligner_matches_jax(algorithm):
    pairs = short_pairs(11)
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    arrays = pack_pairs(qs, ts, 304, 304)
    cfg = AlignerConfig(304, 304, len(pairs))
    j_paths, j_dists, j_status = getattr(jax_ma, ALGORITHMS[algorithm])(
        *arrays, cfg, backend="xla", queries=qs, targets=ts)
    paths, dists = getattr(myers_aligner, ALGORITHMS[algorithm])(
        *arrays, qs, ts, "cpu")
    assert paths == j_paths
    np.testing.assert_array_equal(dists, np.asarray(j_dists))
    assert set(np.asarray(j_status).tolist()) == {0}


def test_escalate_equals_myers_where_banded():
    """Short padded queries route every pair to the banded re-run, where
    both algorithms return the dense canonical path."""
    pairs = short_pairs(12)
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    arrays = pack_pairs(qs, ts, 304, 304)
    m = myers_aligner.myers_align_batch(*arrays, qs, ts, "cpu")
    e = myers_aligner.banded_escalate_align_batch(*arrays, qs, ts, "cpu")
    assert m[0] == e[0]
    np.testing.assert_array_equal(m[1], e[1])


def test_routing_rule():
    route = myers_aligner.routes_to_hirschberg
    # 128 bytes a row up to r = 63, 256 from r = 64
    assert not route(2048, 8) and route(2056, 8)
    assert not route(1032, 32) and route(1032, 64)
    assert not route(1024, 64) and route(1024, 128)
    assert all(route(2056, r) for r in (8, 64, 1024))


def test_c1_span_between_the_caps_routes_to_hirschberg():
    """1032 x 1100 with about 40 edits: the Myers score gives r = 64, and
    1032 * round_up(129, 128) = 264,192 > 2^18, so the pair goes to
    Hirschberg here and on the JAX package's XLA kind (its Pallas kind,
    with a packed-byte cap, would keep it banded).  The paths equal the
    JAX package's."""
    rng = np.random.default_rng(40)
    a = generate_random_genome(1032, rng)
    b = mutate_sequence(a, 40, rng)[:1100]
    port = port_aligner.create_aligner(1032, 1100, 1, algorithm="myers",
                                       device="cpu")
    jax = jax_create_aligner(1032, 1100, 1, algorithm="myers",
                             backend="xla")
    for al in (port, jax):
        al.add_alignment(a, b)
    with profiling.stage_times() as st:
        (got,) = port.get_alignments()
    (want,) = jax.get_alignments()
    assert 33 <= got.edit_distance <= 64                    # r = 64
    assert st.counters["hirschberg.pairs"] == 1
    assert (got.status, got.edit_distance, got.path) == (
        want.status, want.edit_distance, want.path)
