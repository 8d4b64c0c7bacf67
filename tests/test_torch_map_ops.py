"""The port's index build, matching, chaining and compaction
(claragenomicsanalysis_tpu_torch/ops/map_ops.py) against the JAX package's
``ops/map_ops.py`` on the same inputs, on the CPU, element for element.

The JAX package's ``with_packed`` index and ``pack2`` chain paths (2-word
uint32 sorts, ``_start_fill16``) are held against the port's single path
too.  ROADMAP C4 is pinned here: keys at and above 2^31, INVALID rows and a
minimizer whose hash is INVALID itself, read ids near 2^31 and reverse-
strand (negative) chain keys, against the JAX functions on uint32 / int32.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.ops import map_ops as jax_ops
from claragenomicsanalysis_tpu.ops import sketch as jax_sketch
from claragenomicsanalysis_tpu_torch.ops import map_ops
from claragenomicsanalysis_tpu_torch.simulators import (NoisyReadSimulator,
                                                        PoissonGenomeSimulator)
from claragenomicsanalysis_tpu_torch.utils.genomeutils import encode

INVALID = 0xFFFFFFFF
K, W = 15, 5
FIELDS = ("rep", "read_id", "pos", "dir")
ANCHOR_FIELDS = ("q_read", "t_read", "q_pos", "t_pos", "dir", "valid")
CHAIN_ARGS = dict(k=K, min_residues=3, min_overlap_len=100,
                  min_bases_per_residue=500, min_overlap_fraction_num=3,
                  min_overlap_fraction_den=10, max_gap=5000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these small shapes run on one thread: pytest-
    xdist runs several test processes at once, and torch's default pool of
    a thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(ours: dict, theirs: dict, keys):
    for f in keys:
        a, b = np_of(ours[f]), np_of(theirs[f])
        assert a.shape == b.shape, f
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), f


@pytest.fixture(scope="module")
def sketched():
    """The sketch of 20 noisy reads of both strands from a 6 kb genome,
    plus a repeat-rich read that the -F filter thins."""
    genome = PoissonGenomeSimulator(seed=5).build_reference(6000)
    sim = NoisyReadSimulator(seed=5, error_rate=0.05)
    seqs = [r.seq for r in sim.generate_reads(genome, 20, 900)]
    seqs.append("ACGTTGCA" * 60)
    L = 1280
    reads = np.full((len(seqs), L), -1, dtype=np.int8)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = encode(s)
    rep, dirs, is_min = jax_sketch.sketch_batch(
        jnp.asarray(reads), jnp.asarray(lens), K, W, True)
    return np.array(rep), np.array(dirs), np.array(is_min)


def _ours_index(sk, first, num=1, den=1):
    rep, dirs, is_min = sk
    return map_ops.build_index(torch.from_numpy(rep.astype(np.int64)),
                               torch.from_numpy(dirs),
                               torch.from_numpy(is_min), first, num, den)


def _jax_index(sk, first, num=1, den=1, packed=False):
    return jax_ops.build_index(*(jnp.asarray(x) for x in sk),
                               jnp.int32(first), filter_thr_num=num,
                               filter_thr_den=den, with_packed=packed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("F", [1.0, 0.004])
def test_build_index_equals_jax(sketched, F, packed):
    frac = Fraction(F).limit_denominator(10**6)
    ours = _ours_index(sketched, 7, frac.numerator, frac.denominator)
    theirs = _jax_index(sketched, 7, frac.numerator, frac.denominator,
                        packed)
    assert_same(ours, theirs, FIELDS + ("n_elems",))
    n_all = int(sketched[2].sum())
    n = int(ours["n_elems"])
    assert (n < n_all) == (F < 1.0)     # the filter dropped something
    rep = ours["rep"].numpy()
    assert (rep[:n] != INVALID).all() and (rep[n:] == INVALID).all()


def test_build_index_keys_at_and_above_2_31():
    """C4: reps spanning [0, 2^32), a minimizer whose hash equals INVALID,
    and non-minimizer rows, through the unfiltered and the filtered sort."""
    rng = np.random.default_rng(4)
    B, Lk = 6, 40
    pool = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 2,
                     INVALID], dtype=np.uint64)
    rep = np.where(rng.random((B, Lk)) < 0.5,
                   rng.choice(pool, (B, Lk)),
                   rng.integers(0, 2**32, (B, Lk), dtype=np.uint64))
    dirs = rng.integers(0, 2, (B, Lk)).astype(np.int32)
    is_min = rng.random((B, Lk)) < 0.6
    sk = (rep.astype(np.uint32), dirs, is_min)
    sk64 = (rep.astype(np.int64), dirs, is_min)
    assert is_min[rep == INVALID].any()
    for num, den in ((1, 1), (1, 20)):
        ours = _ours_index(sk64, 3, num, den)
        theirs = _jax_index(sk, 3, num, den)
        assert_same(ours, theirs, FIELDS + ("n_elems",))
        srep = ours["rep"].numpy()
        assert (np.diff(srep) >= 0).all() and (srep >= 2**31).any()
    # matching on these keys: the same target ranges and anchors
    q, t = _ours_index(sk64, 0), _ours_index(sk64, 100)
    qj, tj = _jax_index(sk, 0), _jax_index(sk, 100)
    lo, cum, total = map_ops.match_count(q, t)
    lo_j, cum_j, total_j = jax_ops.match_count(qj, tj)
    assert np.array_equal(lo.numpy(), np.asarray(lo_j))
    assert np.array_equal(cum.numpy(), np.asarray(cum_j))
    cap = int(total) + 16
    assert_same(map_ops.match_expand(q, t, lo, cum, cap),
                jax_ops.match_expand(qj, tj, lo_j, cum_j, cap=cap),
                ANCHOR_FIELDS)


@pytest.fixture(scope="module")
def indices(sketched):
    ours = _ours_index(sketched, 0)
    theirs = _jax_index(sketched, 0)
    return ours, theirs


@pytest.mark.parametrize("skip_self", [True, False])
def test_match_count_and_expand_equal_jax(indices, skip_self):
    ours, theirs = indices
    lo, cum, total = map_ops.match_count(ours, ours)
    lo_j, cum_j, total_j = jax_ops.match_count(theirs, theirs)
    assert np.array_equal(lo.numpy(), np.asarray(lo_j))
    assert np.array_equal(cum.numpy(), np.asarray(cum_j))
    assert int(total) == int(total_j) > 1000
    # a cut count (truncation) and a padded one (INVALID rows past the
    # count; the true count's rows are its head)
    for cap in (int(total) // 3, int(total) + 100):
        a = map_ops.match_expand(ours, ours, lo, cum, cap, skip_self)
        b = jax_ops.match_expand(theirs, theirs, lo_j, cum_j, cap=cap,
                                 skip_self=skip_self)
        assert_same(a, b, ANCHOR_FIELDS)
        assert a["valid"].sum() < cap if skip_self else True
    a, n, over = map_ops.match_anchors(ours, ours, int(total) - 1)
    assert (int(n), bool(over)) == (int(total), True)


@pytest.fixture(scope="module")
def anchors(indices):
    """Anchors at a capacity past the true count (INVALID rows at the end,
    self-mappings invalid in the middle), in the port's and JAX's form."""
    ours, theirs = indices
    lo, cum, total = map_ops.match_count(ours, ours)
    cap = int(total) + 64
    a = map_ops.match_expand(ours, ours, lo, cum, cap)
    return a, {f: jnp.asarray(v.numpy()) for f, v in a.items()}


def _jax_chain(anchors_j, pack2):
    return jax_ops.chain_anchors(anchors_j, pack2=pack2, **CHAIN_ARGS)


def test_chain_anchors_equals_jax(anchors):
    a, a_j = anchors
    ours = map_ops.chain_anchors(a, **CHAIN_ARGS)
    theirs = _jax_chain(a_j, False)
    assert_same(ours, theirs, map_ops.OVERLAP_FIELDS + ("valid",))
    assert 0 < int(ours["valid"].sum())
    assert set(ours["dir"][ours["valid"]].tolist()) == {0, 1}


def test_chain_anchors_equals_jax_pack2_and_fill16(anchors):
    """JAX's pack2 path sorts two packed uint32 words and forward-fills
    the chain starts (``_start_fill16``): its valid rows are the port's."""
    a, a_j = anchors
    ours = map_ops.chain_anchors(a, **CHAIN_ARGS)
    theirs = _jax_chain(a_j, True)
    v = ours["valid"].numpy()
    assert np.array_equal(v, np.asarray(theirs["valid"]))
    for f in map_ops.OVERLAP_FIELDS:
        assert np.array_equal(ours[f].numpy()[v], np.asarray(theirs[f])[v]), f
    stacked, nv = map_ops.compact_overlaps(ours)
    stacked_j, nv_j = jax_ops.compact_overlaps(theirs)
    assert int(nv) == int(nv_j)
    assert np.array_equal(stacked.numpy()[:, :int(nv)],
                          np.asarray(stacked_j)[:, :int(nv)])


def test_chain_c4_large_ids_and_reverse_keys():
    """C4 in the chain sort's packing: read ids up to 2^31 - 2, positions
    up to 2^30 - 1, reverse-strand keys (-t_pos), invalid rows between."""
    rng = np.random.default_rng(9)
    n = 3000
    ids = np.array([0, 5, 2**15, 2**16 + 3, 2**31 - 2], dtype=np.int32)
    pos = np.sort(rng.integers(0, 2**30 - 1, n)).astype(np.int32)
    a = {"q_read": rng.choice(ids, n).astype(np.int32),
         "t_read": rng.choice(ids, n).astype(np.int32),
         "q_pos": pos, "t_pos": rng.permutation(pos).astype(np.int32),
         "dir": rng.integers(0, 2, n).astype(np.int32),
         "valid": rng.random(n) < 0.9}
    # chains: runs of small steps on one (q, t, dir)
    a["q_pos"][:200] = np.arange(200) * 40
    a["t_pos"][:200] = 90_000 - np.arange(200) * 41
    a["dir"][:200], a["q_read"][:200], a["t_read"][:200] = 1, 2**31 - 2, 5
    a["valid"][:200] = True
    # reverse-strand keys 0, -3, -9 at one query position: -t_pos = 0 must
    # sort after the negative keys
    a["q_pos"][200:206], a["t_pos"][200:206] = 5000, [0, 3, 0, 9, 3, 1]
    a["dir"][200:206], a["q_read"][200:206], a["t_read"][200:206] = 1, 0, 0
    a["valid"][200:206] = True
    args = dict(CHAIN_ARGS, max_gap=2**29, min_residues=2)
    ours = map_ops.chain_anchors({k: torch.from_numpy(v)
                                  for k, v in a.items()}, **args)
    theirs = jax_ops.chain_anchors({k: jnp.asarray(v) for k, v in a.items()},
                                   **args)
    assert_same(ours, theirs, map_ops.OVERLAP_FIELDS + ("valid",))
    assert int(ours["valid"].sum()) > 0


def test_count_and_compactions_equal_jax(anchors):
    a, a_j = anchors
    ours = map_ops.chain_anchors(a, **CHAIN_ARGS)
    theirs = _jax_chain(a_j, False)
    assert int(map_ops.count_valid(ours)) == int(jax_ops.count_valid(theirs))
    stacked, nv = map_ops.compact_overlaps(ours)
    stacked_j, nv_j = jax_ops.compact_overlaps(theirs)
    assert int(nv) == int(nv_j)
    assert np.array_equal(stacked.numpy(), np.asarray(stacked_j))
    out_cap = 1 << (int(nv) - 1).bit_length()
    assert np.array_equal(
        map_ops.compact_overlaps_gather(ours, out_cap).numpy(),
        np.asarray(jax_ops.compact_overlaps_gather(theirs, out_cap)))


def test_wrap32_is_int32_arithmetic():
    x = torch.tensor([2**31 - 1 + 15, -(2**31) - 1, 2**40 + 7, -5, 0])
    want = (np.array([2**31 - 1], np.int32) + np.int32(15)).tolist() + [
        2**31 - 1, 7, -5, 0]
    assert map_ops.wrap32(x).tolist() == want
