"""The port's minimizer sketch (claragenomicsanalysis_tpu_torch/ops/sketch.py)
against the JAX package's ``ops/sketch.py`` and ``cpu/mapper_oracle.py`` on
the CPU.  Exact: the results are integers.  The 32-bit values travel as
int64 in the port (ROADMAP C4), so the hash is held at and above 2^31."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.config import MapperConfig as JaxCfg
from claragenomicsanalysis_tpu.cpu import mapper_oracle
from claragenomicsanalysis_tpu.ops import sketch as jax_sketch
from claragenomicsanalysis_tpu_torch.ops import sketch
from claragenomicsanalysis_tpu_torch.utils.genomeutils import encode

EDGES = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these small shapes run on one thread: pytest-
    xdist runs several test processes at once, and torch's default pool of
    a thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hash_inputs() -> np.ndarray:
    rng = np.random.default_rng(31)
    high = rng.integers(2**31, 2**32, size=4096, dtype=np.uint64)
    low = rng.integers(0, 2**31, size=1024, dtype=np.uint64)
    return np.concatenate([np.array(EDGES, np.uint64), high, low])


@pytest.mark.parametrize("reference", ["jax", "oracle"])
def test_murmur32_at_and_above_2_31(reference):
    x = _hash_inputs()
    ours = sketch.murmur32(torch.from_numpy(x.astype(np.int64))).numpy()
    if reference == "jax":
        theirs = np.asarray(jax_sketch.murmur32(jnp.asarray(
            x.astype(np.uint32))))
    else:
        theirs = mapper_oracle.murmur32(x.astype(np.uint32))
    assert ours.dtype == np.int64 and ours.min() >= 0
    assert np.array_equal(ours, theirs.astype(np.int64))
    # the top bit is set in about half the outputs: the order of int64
    # values in [0, 2^32) is uint32's
    assert 0.4 < np.mean(ours >= 2**31) < 0.6


def _reads(k: int, w: int) -> list[str]:
    """Random reads with N, lower case, one shorter than k, one shorter
    than k + w - 1 (fewer k-mers than a window), an empty one, and a
    read that is its own reverse complement at the start."""
    rng = np.random.default_rng(k * 100 + w)
    bases = np.array(list("ACGT"))
    out = ["".join(rng.choice(bases, n)) for n in (700, 333, 512, 96)]
    s = list(out[0])
    for p in rng.integers(0, len(s), 9):
        s[p] = "N"
    out[0] = "".join(s)
    out[1] = out[1][:100].lower() + out[1][100:]
    out += ["".join(rng.choice(bases, k - 1)),
            "".join(rng.choice(bases, k + w - 3)) if k + w - 3 >= k
            else "".join(rng.choice(bases, k)),
            "", "ACGT" * 40 + "NNNN" + "GATTACA" * 20]
    return out


def _batch(seqs: list[str], L: int):
    reads = np.full((len(seqs), L), -1, dtype=np.int8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = encode(s)
        lens[i] = len(s)
    return reads, lens


#: (k, w, hashed): both of the golden's and the defaults' windows, the
#: high word of k = 19 and k = 31, unhashed k <= 15
CASES = [(15, 5, True), (15, 15, True), (19, 10, True), (31, 7, True),
         (15, 5, False), (9, 3, False)]


@pytest.mark.parametrize("k,w,hashed", CASES)
def test_sketch_batch_equals_jax_and_oracle(k, w, hashed):
    seqs = _reads(k, w)
    reads, lens = _batch(seqs, 768)
    ours = sketch.sketch_batch(torch.from_numpy(reads),
                               torch.from_numpy(lens), k, w, hashed)
    theirs = jax_sketch.sketch_batch(jnp.asarray(reads), jnp.asarray(lens),
                                     k, w, hashed)
    rep, dirs, is_min = (x.numpy() for x in ours)
    assert rep.dtype == np.int64
    assert np.array_equal(rep, np.asarray(theirs[0]).astype(np.int64))
    assert np.array_equal(dirs, np.asarray(theirs[1]))
    assert np.array_equal(is_min, np.asarray(theirs[2]))
    assert (rep >= 2**31).any() if hashed else (rep[rep != 2**32 - 1]
                                                < 2**30).all()
    cfg = JaxCfg(kmer_size=k, window_size=w, hash_representations=hashed)
    for i, s in enumerate(seqs):
        want = mapper_oracle.sketch_read(s, i, cfg)
        got = np.flatnonzero(is_min[i])
        assert got.tolist() == [e.position_in_read for e in want], i
        assert rep[i, got].tolist() == [e.representation for e in want]
        assert dirs[i, got].tolist() == [e.direction for e in want]
    assert not is_min[4].any() and not is_min[6].any()   # < k, empty
    assert 0 < lens[5] - k + 1 < w and is_min[5].any()   # < one window


def test_sketch_refuses_reads_shorter_than_k():
    with pytest.raises(ValueError, match="shorter than k"):
        sketch.sketch_batch(torch.zeros((1, 4), dtype=torch.int8),
                            torch.tensor([4]), 5, 3)
