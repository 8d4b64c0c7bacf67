"""Every shape the reference aligns, on the port's kernels: the named
functions that choose each kernel's variant (shared or device memory, warp
or block, lanes and passes) pinned at the thresholds where they switch, the
plain Myers version run in passes against its one-pass run and the JAX
package's scan, and, on the card, each variant of B1, B3, B4, B5, B7 and B8
against its plain version.

The thresholds come from each variant's shared-memory bytes against the
227 KB (232,448 B) a Hopper block can have.  Integer DP: every comparison
is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.core.config import PoaScores as JaxPoaScores
from claragenomicsanalysis_tpu.ops import poa_ops
from claragenomicsanalysis_tpu.ops.myers import myers_bottom_row as jax_myers
from claragenomicsanalysis_tpu.utils.genomeutils import (
    encode, generate_random_genome, mutate_sequence)
from claragenomicsanalysis_tpu_torch.core.config import BatchSize, PoaScores
from claragenomicsanalysis_tpu_torch.models import poa
from claragenomicsanalysis_tpu_torch.models.aligner import bucket_radius
from claragenomicsanalysis_tpu_torch.ops import (_build, banded, myers,
                                                 nw_diag, nw_row,
                                                 poa_consensus, poa_nwtb,
                                                 poa_topsort, poa_window)
from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs


#: scores whose cells pass the 24 bits of B5's 4-byte plane word at the
#: small shapes below (|score| x (N + L + 1) >= 2^22): B5 runs on 8-byte
#: words
WIDE = PoaScores(match_score=20_000, mismatch_score=-15_000,
                 gap_score=-20_000)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ----------------------------------------------------- the variant choices


def test_smem_limit_is_a_hopper_block():
    assert _build.SMEM_PER_BLOCK == 232_448


@pytest.mark.parametrize("lq_lt, variant", [(84_344, "shared"),
                                            (84_345, "device")])
def test_nw_diag_switches_at_r_16448(lq_lt, variant):
    """r = 16,448 (lengths 8,193-16,384 apart): W = 16,456, 9W = 148,104,
    so padded Lq + Lt = 84,344 is the last that fits a block."""
    assert bucket_radius(64, 8_193) == bucket_radius(64, 16_384) == 16_448
    assert nw_diag.nw_diag_smem_bytes(40_000, lq_lt - 40_000, 16_448) == \
        148_104 + lq_lt
    assert nw_diag.nw_diag_plan(40_000, lq_lt - 40_000, 16_448) == \
        ("block-" + variant, 0, 1)
    want = 0 if variant == "shared" else 9 * 16_456
    assert nw_diag.nw_diag_scratch_bytes(40_000, lq_lt - 40_000,
                                         16_448) == want


def test_lengths_16385_apart_need_device_memory_in_both_kernels():
    """|lq - lt| = 16,385 gives r = 32,832: W = 32,840 slots (B1) or 65,672
    lanes (B3), past a block whatever the lengths; B3 then runs nine lane
    groups of 8 a thread (928 threads), past the 65,536 lanes one group of
    64 lanes and 1,024 threads could hold."""
    r = bucket_radius(64, 16_385)
    assert r == 32_832
    assert nw_diag.nw_diag_plan(1_000, 17_392, r) == ("block-device", 0, 1)
    assert nw_diag.nw_diag_scratch_bytes(1_000, 17_392, r) == 9 * 32_840
    assert nw_row.band_width_row(r) == 65_672
    assert nw_row.nw_row_plan(8, 8, r) == ("block-device", 8, 9, 928)
    assert nw_row.nw_row_scratch_bytes(8, 8, r) == 4 * 65_673


@pytest.mark.parametrize("r, plan", [
    (7, ("warp-shared", 1, 4)),           # W = 8
    (31, ("warp-shared", 1, 4)),          # W = 32: one slot a lane
    (32, ("warp-shared", 2, 4)),          # W = 40: Hirschberg's base case
    (63, ("warp-shared", 2, 4)),          # W = 64
    (72, ("warp-shared", 3, 4)),          # W = 80: the main path's bucket
    (127, ("warp-shared", 4, 4)),         # W = 128
    (200, ("warp-shared", 7, 4)),         # W = 208
    (255, ("warp-shared", 8, 4)),         # W = 256: the widest a warp takes
    (256, ("block-shared", 0, 1)),        # W = 264: a block a problem
])
def test_nw_diag_plan_by_band(r, plan):
    """A warp a problem up to W = 256 slots, K the fewest slots a lane
    with 32 K >= W; wider bands a block a problem."""
    assert nw_diag.nw_diag_plan(10_000, 10_008, r) == plan
    W = nw_diag.band_slots(r)
    variant, K, _ = plan
    if variant.startswith("warp"):
        assert 32 * K >= W > 32 * (K - 1)
    assert nw_diag.nw_diag_scratch_bytes(10_000, 10_008, r) == 0


@pytest.mark.parametrize("lq_lt, plan", [
    (58_112, ("warp-shared", 8, 4)),      # 4 x 58,112 = 232,448 B
    (58_128, ("warp-shared", 8, 2)),
    (116_224, ("warp-shared", 8, 2)),
    (116_240, ("warp-shared", 8, 1)),
    (232_448, ("warp-shared", 8, 1)),
    (232_464, ("warp-device", 8, 4)),     # q and t read through L1
])
def test_nw_diag_warp_plan_stages_while_q_and_t_fit(lq_lt, plan):
    """A warp's copy of q and t (each rounded up to 16 bytes) sets the
    problems a block: 4, 2 or 1 whose copies fit 227 KB, else 4 a block
    reading q and t through L1.  No warp plan takes device scratch."""
    Lq = lq_lt // 32 * 16
    assert nw_diag.nw_diag_stage_bytes(Lq, lq_lt - Lq) == lq_lt
    assert nw_diag.nw_diag_plan(Lq, lq_lt - Lq, 255) == plan
    assert nw_diag.nw_diag_scratch_bytes(Lq, lq_lt - Lq, 255) == 0
    assert nw_diag.nw_diag_stage_bytes(0, 3) == 32


@pytest.mark.parametrize("r, plan", [
    (72, ("warp-shared", 5, 4, 128)),     # the main path's bucket: a warp
    (2_100, ("block-shared", 8, 1, 544)),  # banded-escalate's wide bands
    (4_095, ("block-shared", 8, 1, 1024)),  # W = 8,192: one group of 8
    (4_096, ("block-device", 8, 2, 544)),  # W = 8,200: two groups
    (29_040, ("block-device", 8, 8, 928)),  # also past a block's 227 KB
    (70_000, ("block-device", 8, 18, 992)),  # 18 lane groups of 8
])
def test_nw_row_plan(r, plan):
    assert nw_row.nw_row_plan(8, 8, r) == plan
    variant, lanes, n, threads = plan
    W = nw_row.band_width_row(r)
    if variant.startswith("warp"):     # K lanes a thread, n problems
        assert 32 * lanes >= W > 32 * (lanes - 1) and threads == 32 * n
        return
    assert (variant == "block-shared") == (
        nw_row.nw_row_smem_bytes(8, 8, r) <= _build.SMEM_PER_BLOCK
        and W <= nw_row.MAX_CPT * nw_row.MAX_THREADS)
    assert threads <= 1024 and lanes * n * threads >= W
    assert lanes * n * (threads - 32) < W


def test_launch_chunks_count_the_device_variants_scratch():
    """A launch's problems are cut by their tracebacks plus the scratch of
    the variant they run: none for the shared variant."""
    r = 32_832
    per = banded.tb_bytes_per_problem(1_000, 17_392, r, "diag") + 9 * 32_840
    assert banded.scratch_bytes_per_problem(1_000, 17_392, r) == 9 * 32_840
    n = banded.MEM_BUDGET_PER_DISPATCH // per
    assert [len(c) for c in banded.launch_chunks(
        range(n + 1), 1_000, 17_392, r)] == [n, 1]
    assert banded.scratch_bytes_per_problem(10_000, 10_008, 72) == 0
    assert banded.scratch_bytes_per_problem(10_000, 10_008, 72, "row") == 0


@pytest.mark.parametrize("S, variant", [(1_816, ("warp-shared", 1)),
                                        (1_817, ("warp-shared", 1))])
def test_consensus_switches_near_1800_bases(S, variant):
    """cli poa sizes a batch from its longest sequence S: N = 3S (padded
    to 8), P = 4, MC = 2S.  B8's first design kept a tied-pred list of N P
    ints among its tables (about 128 S bytes) and left shared memory past
    1,816 bases; its tables now take 4 (6N + MC), about 80 S bytes, so
    both sizes keep them in shared memory, one window a block
    (tests/test_torch_consensus_plan.py pins where that ends: 2,904 /
    2,905)."""
    bs = BatchSize(max_sequence_size=S, max_sequences_per_poa=3)
    N, P, MC = bs.padded_nodes, bs.max_pred_per_node, bs.max_consensus_size
    assert poa_consensus.consensus_table_bytes(N, MC) == 4 * (6 * N + MC)
    assert poa_consensus.consensus_plan(3, N, P, MC) == variant


@pytest.mark.parametrize("S, plan", [(2_048, ("warp-shared", 1)),
                                     (2_768, ("warp-shared", 1)),
                                     (9_000, ("warp-device", 4))])
def test_topsort_variant(S, plan):
    """cli poa sizes a batch from its longest sequence S: N = 3S (padded
    to 8); B7's tables take 4 (5N + 2) bytes a window."""
    bs = BatchSize(max_sequence_size=S, max_sequences_per_poa=3)
    N = bs.padded_nodes
    assert poa_topsort.topsort_table_bytes(N) == 4 * (5 * N + 2)
    assert poa_topsort.topsort_plan(N) == plan


@pytest.mark.parametrize("L, plan", [
    (8_191, ("block", 1024, 4)),      # the first design refused L > 8,191
    (8_192, ("block", 1024, 4)),
    (512, ("block", 160, 8)),         # 513 columns: past a warp's 512
    (511, ("warp", 128, 8)),
    (256, ("warp", 128, 8)),          # the correction shape's rows
])
def test_nwtb_plan_has_no_length_cap(L, plan, monkeypatch):
    N, P = 3 * L, 4
    assert poa_nwtb.nwtb_plan(4096, N, P, L, 0) == plan
    monkeypatch.setattr(poa_nwtb, "RING_ROWS", 0)
    assert poa_nwtb.nwtb_plan(4096, N, P, L, 0) == plan[:2] + (0,)


def test_nwtb_plan_by_window_count(monkeypatch):
    """The correction shape's 2,159 windows go a warp each; the deep
    shape's 419 (banded: 257 columns) a block of four warps each, as does
    any launch of up to 1,056 windows (BLOCK_WINDOWS); rows of more than
    512 columns always go a block."""
    assert poa_nwtb.ring_width(512, 256) == 257
    assert poa_nwtb.nwtb_plan(2159, 384, 8, 256, 0) == ("warp", 128, 8)
    assert poa_nwtb.nwtb_plan(1057, 384, 8, 256, 0)[0] == "warp"
    assert poa_nwtb.nwtb_plan(1056, 384, 8, 256, 0) == ("block", 128, 8)
    assert poa_nwtb.nwtb_plan(419, 1024, 16, 512, 256) == ("block", 128, 8)
    assert poa_nwtb.nwtb_smem_bytes(1024, 16, 512, 256) == \
        4 * (8 * 257 + 2 * (4 + 3 * 16) + 512 // 4)
    monkeypatch.setattr(poa_nwtb, "BLOCK_WINDOWS", 0)
    assert poa_nwtb.nwtb_plan(419, 1024, 16, 512, 256)[0] == "warp"
    assert poa_nwtb.nwtb_plan(9, 1024, 16, 512, 0)[0] == "block"


def test_nwtb_ring_shrinks_to_fit_a_block():
    """At L = 60,000 even two ring rows pass a block: no ring, every pred
    read from the plane."""
    assert poa_nwtb.nwtb_plan(1, 3, 4, 20_000, 0)[2] == 2
    assert poa_nwtb.nwtb_plan(1, 3, 4, 60_000, 0)[2] == 0


@pytest.mark.parametrize("N_plus_L, word", [(524_286, 4), (524_287, 8)])
def test_nwtb_word_switches_at_2_22(N_plus_L, word):
    """With the default scores (|score| <= 8) a real cell fits the 4-byte
    word's 24 bits while 8 (N + L + 1) < 2^22; the plane and the ring then
    take 8-byte words."""
    N = 3 * (N_plus_L // 4)
    L = N_plus_L - N
    assert poa_nwtb.nwtb_word_bytes(N, L, PoaScores()) == word
    assert poa_nwtb.plane_bytes(N, L) == word * (N + 1) * (L + 1)


def test_nwtb_wide_scores_take_8_byte_words():
    """cli poa's 9,000-base windows keep 4-byte words with the default
    scores; the WIDE scores need 8 at 100 bases, and the window's bytes and
    shared memory count them."""
    bs = BatchSize(max_sequence_size=9_000, max_sequences_per_poa=3)
    assert poa_nwtb.nwtb_word_bytes(bs.padded_nodes, bs.padded_seq,
                                    PoaScores()) == 4
    bs = BatchSize(max_sequence_size=100, max_sequences_per_poa=5)
    N, L = bs.padded_nodes, bs.padded_seq
    assert poa_nwtb.nwtb_word_bytes(N, L, WIDE) == 8
    assert poa.window_bytes(bs, scores=WIDE) - poa.window_bytes(bs) == \
        4 * (N + 1) * (L + 1)
    # the ring's words are twice the bytes; a window's ints stay even
    assert poa_nwtb.nwtb_smem_bytes(N, 4, L, 0, 8, word=8) == \
        4 * (8 * 129 * 2 + 2 * (4 + 12) + 32)
    assert poa_nwtb.nwtb_smem_bytes(N, 4, 127, 0, 0, word=8) == \
        4 * (2 * (4 + 12) + 32)
    assert poa_nwtb.nwtb_smem_bytes(N, 4, 125, 0, 0, word=8) == \
        4 * (2 * (4 + 12) + 32)


@pytest.mark.parametrize("P", [64, 65])
def test_nwtb_plan_takes_any_pred_count(P):
    """A warp carries 64 pred slots a row in flight and loads the rest when
    the row lands: P = 65 keeps the warp variant and the ring."""
    assert poa_nwtb.nwtb_plan(2159, 384, P, 256, 0) == ("warp", 128, 8)
    assert poa_nwtb.nwtb_plan(419, 1024, P, 512, 256) == ("block", 128, 8)


def test_nwtb_plan_refuses_only_past_a_block():
    """Only where a window's two rows of pred facts and its sequence pass
    a block even without a ring (P about 9,600) is B5 refused; P = 2,500
    moves a warp launch to a block a window."""
    assert poa_nwtb.nwtb_plan(2159, 384, 2_000, 256, 0)[0] == "warp"
    assert poa_nwtb.nwtb_plan(2159, 384, 2_500, 256, 0)[0] == "block"
    assert poa_nwtb.nwtb_plan(2159, 384, 9_600, 256, 0) == ("block", 128, 0)
    with pytest.raises(ValueError, match="past a block"):
        poa_nwtb.nwtb_plan(2159, 384, 9_700, 256, 0)


#: the smoke's three POA shapes: correction, deep (banded), MSA
CORR = BatchSize(max_sequence_size=256, max_nodes_per_window=384,
                 max_sequences_per_poa=8, max_pred_per_node=8,
                 max_aligned_per_node=4)
DEEP = BatchSize(max_sequence_size=512, max_sequences_per_poa=16,
                 max_pred_per_node=16, max_aligned_per_node=8,
                 max_nodes_per_window=1024)
MSA_BS = BatchSize(max_sequence_size=128, max_sequences_per_poa=8,
                   max_pred_per_node=4, max_aligned_per_node=4,
                   max_nodes_per_window=256)


@pytest.mark.parametrize("W, bs, band, plan", [
    (2_219, CORR, 0, ("warp", 128, 8)),   # the correction shape's launch
    (4_096, MSA_BS, 0, ("warp", 128, 8)),  # the MSA shape's
    (434, DEEP, 256, ("block", 128, 8)),  # the deep shape's, banded
    (1_056, CORR, 0, ("block", 128, 8)),  # 8 windows an SM: a block each
    (1_057, CORR, 0, ("warp", 128, 8)),
    (4_096, BatchSize(max_sequence_size=1_024, max_sequences_per_poa=4),
     0, ("block", 288, 8)),               # rows of 1,025 columns
])
def test_window_plan_by_window_count_and_shape(W, bs, band, plan):
    """B10 takes a warp a window where the launch has more windows than 8
    an SM and a row fits a warp, else a block a window, as B5 does."""
    assert poa_window.window_plan(W, bs, band) == plan


@pytest.mark.parametrize("bs, band, smem, scratch", [
    # ring 8 x 257 words, facts 2 x (4 + 3 x 8), sequence 64, state 4 ints
    (CORR, 0, 4 * (8 * 257 + 56 + 64 + 4),
     4 * (384 * 28 + 2 * 640 + 6 * 384 + 512)),
    (DEEP, 256, 4 * (8 * 257 + 104 + 128 + 4),
     4 * (1024 * 48 + 2 * 1536 + 6 * 1024 + 1024)),
    (MSA_BS, 0, 4 * (8 * 129 + 32 + 32 + 4),
     4 * (256 * 20 + 2 * 384 + 6 * 256 + 256)),
])
def test_window_counts_at_the_smoke_shapes(bs, band, smem, scratch):
    """A window's shared memory (the graph NW's ring, two rows' facts, the
    sequence, four words of state) and its slice of the device scratch
    (the graph, the path, the largest phase's tables), as the kernel lays
    them out; a few KB of shared memory, so 16-32 windows an SM fit."""
    assert poa_window.window_smem_bytes(bs, band) == smem
    assert poa_window.window_scratch_bytes(bs) == scratch
    assert poa_window.window_smem_bytes(bs, band, word=8) > smem
    assert 4 * smem < 48 * 1024


@pytest.mark.parametrize("bs, msa, n, sizes", [
    (CORR, False, 4_096, [2_277, 1_819]),
    (MSA_BS, True, 4_096, [4_096]),
    (DEEP, False, 512, [446, 66]),
])
def test_launch_chunks_follow_the_window_route(bs, msa, n, sizes):
    """The window route's launches are cut by its own bytes a window: the
    plane, the scratch slice, the sequences and weights (with the MSA its
    paths and rows); the lockstep route's stay as they were."""
    got = poa.launch_chunks(n, bs, msa, kernel="window")
    assert [len(c) for c in got] == sizes
    assert poa.window_bytes(bs, msa, kernel="window") == (
        poa_nwtb.plane_bytes(bs.padded_nodes, bs.padded_seq)
        + poa_window.window_scratch_bytes(bs)
        + 8 * bs.max_sequences_per_poa * bs.padded_seq
        + (4 * bs.max_sequences_per_poa
           * (bs.padded_seq + bs.padded_nodes) if msa else 0))
    assert poa.launch_chunks(n, bs, msa) == poa.launch_chunks(
        n, bs, msa, kernel="lockstep")


def fan_in(P: int, W: int, seed: int):
    """W windows of P source nodes feeding one node (P preds, its slots in
    order 0..P-1), then one node after it: the graph NW's inputs with the
    identity topological order.  Window 0's only source whose base matches
    the sequence's first is the last slot's, so its path goes through slot
    P - 1; the others are random.  -> (the port's 10 inputs, as NumPy)"""
    rng = np.random.default_rng(seed)
    N, L = -(-(P + 2) // 8) * 8, 16
    nc = P + 2
    seq = np.full((W, L), -1, np.int32)
    slen = np.zeros(W, np.int32)
    base = np.zeros((W, N), np.int32)
    for w in range(W):
        n = 3 if w == 0 else int(rng.integers(2, L + 1))
        seq[w, :n] = rng.integers(0, 4, n)
        slen[w] = n
        base[w, :nc] = rng.integers(0, 4, nc)
    base[0, :P] = (seq[0, 0] + 1) % 4
    base[0, P - 1], base[0, P], base[0, P + 1] = seq[0, :3]
    order = np.tile(np.arange(N, dtype=np.int32), (W, 1))
    npred = np.zeros((W, N), np.int32)
    npred[:, P], npred[:, P + 1] = P, 1
    pred = np.full((W, N, P), -1, np.int32)
    pred[:, P, :] = np.arange(P)
    pred[:, P + 1, 0] = P
    nsucc = np.zeros((W, N), np.int32)
    nsucc[:, :P + 1] = 1
    return (seq, order, order.copy(), npred, base, nsucc, pred, slen,
            np.full(W, nc, np.int32), np.ones(W, bool))


def jax_graph_nw_traceback(args, scores: PoaScores):
    """poa_ops.graph_nw and nw_traceback window by window."""
    seq, order, rank, npred, base, nsucc, pred, slen, nc, _ = args
    sc = JaxPoaScores(scores.match_score, scores.mismatch_score,
                      scores.gap_score)
    N, P = pred.shape[1:]
    TL = N + seq.shape[1]
    j = jnp.asarray
    outs = []
    for w in range(seq.shape[0]):
        z = j(np.zeros(N, np.int32))
        st = poa_ops.PoaState(
            base=j(base[w]), cov=z, npred=j(npred[w]), pred=j(pred[w]),
            predw=j(np.zeros((N, P), np.int32)), nsucc=j(nsucc[w]), nalig=z,
            alig=j(np.zeros((N, 1), np.int32)), node_count=j(nc[w]),
            status=j(np.int32(0)), paths=j(np.zeros((1, 1), np.int32)))
        smat = poa_ops.graph_nw(st, j(order[w]), j(rank[w]), j(seq[w]),
                                j(slen[w]), sc)
        outs.append([np.asarray(a) for a in poa_ops.nw_traceback(
            st, j(order[w]), j(rank[w]), smat, j(seq[w]), j(slen[w]), sc,
            TL)])
    return [np.stack(o) for o in zip(*outs)]


@pytest.mark.parametrize("P, scores", [(64, PoaScores()), (65, PoaScores()),
                                       (65, WIDE)])
def test_fan_in_graph_matches_poa_ops(P, scores):
    """The wrapper on CPU tensors (its plain version) equals poa_ops at 64
    and 65 pred slots, with the default and the WIDE scores; window 0's
    path goes through slot P - 1."""
    args = fan_in(P, 3, 11)
    got = poa_nwtb.graph_nw_traceback(
        *(torch.from_numpy(a) for a in args), scores)
    want = jax_graph_nw_traceback(args, scores)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    TL = got[0].shape[1]
    assert got[0][0, TL - 3:].tolist() == [P - 1, P, P + 1]


@pytest.mark.parametrize("words, plan", [
    (1, (1, 8, 1)), (32, (4, 8, 1)), (157, (32, 16, 1)), (313, (32, 16, 1)),
    (4_096, (32, 16, 8)), (4_097, (32, 16, 9))])
def test_myers_plan(words, plan):
    """G lanes a problem, K words a lane, passes of G K words: 157 words is
    Hirschberg's level 0 at 10 kb, 313 the score pass at 10 kb, 4,097 the
    first length past the first design's 4,096-word cap."""
    assert myers.myers_plan(words) == plan


def test_myers_has_no_query_cap():
    assert not hasattr(myers, "MAX_WORDS")
    G, K, passes = myers.myers_plan(1 << 20)
    assert (G, K) == (32, 16) and passes * G * K >= 1 << 20


# ------------------------------------------- the plain Myers, in passes


def myers_pairs(seed: int, lq: int = 200, lt: int = 216):
    rng = np.random.default_rng(seed)
    pairs = []
    for n in (1, 31, 32, 33, 64, 65, 96, 150, lq):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a, int(rng.integers(0, 12)),
                                         rng)[:lt]))
    a = generate_random_genome(120, rng)
    pairs += [("", "ACGTACGT"), ("ACGTAC", ""), ("", ""),
              (a[:40] + "N" * 20 + a[60:], a), (a, a[:7])]
    return pack_pairs([x for x, _ in pairs], [y for _, y in pairs], lq, lt)


@pytest.mark.parametrize("pass_words", [1, 2, 3])
def test_myers_passes_equal_one_pass_and_jax(pass_words):
    """Query words in passes of 1-3, joined by the carry of every column,
    give the one-pass rows, and the JAX package's scan (Lq = 200: 7
    words)."""
    arrays = myers_pairs(pass_words)
    args = tuple(torch.from_numpy(x) for x in arrays)
    rows, scores = myers.myers_bottom_row_torch(*args, pass_words=pass_words)
    one_rows, one_scores = myers.myers_bottom_row_torch(*args)
    assert torch.equal(rows, one_rows) and torch.equal(scores, one_scores)
    j_rows, j_scores = jax_myers(*arrays)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(j_scores))


# ------------------------------------------------------------------ the card


def pair_batch(pairs, lq, lt, device):
    arrays = pack_pairs([a for a, _ in pairs], [b for _, b in pairs], lq, lt)
    return tuple(torch.from_numpy(x).to(device) for x in arrays)


def wide_pairs(seed: int, lq: int, lt: int):
    """Short pairs whose lengths differ by up to lt, under any wide band."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(6):
        a = generate_random_genome(int(rng.integers(1, lq + 1)), rng)
        b = mutate_sequence(a, 10, rng)[:lt]
        pairs.append((a, b))
    a = generate_random_genome(lq, rng)
    return pairs + [(a, generate_random_genome(lt, rng)), ("", a[:50]),
                    (a[:30] + "NN", a[:30] + "NN")]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [25_800, 32_832, 70_000])
def test_banded_device_variants_match_plain_versions(r, cuda_device):
    """B1's and B3's device-memory variants (B3 in 7, 9 and 18 lane groups
    of 8 lanes), scores and the whole traceback."""
    q, qlen, t, tlen = pair_batch(wide_pairs(r, 160, 400), 160, 400,
                                  cuda_device)
    assert nw_diag.nw_diag_plan(160, 400, r)[0] == "block-device"
    for nw, plain in ((nw_diag.banded_nw_diag, nw_diag.banded_nw_diag_torch),
                      (nw_row.banded_nw_row, nw_row.banded_nw_row_torch)):
        got = nw(q, qlen, t, tlen, r)
        torch.cuda.synchronize()
        want = plain(q, qlen, t, tlen, r)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def near_pairs(seed: int, n: int, lq: int, lt: int, r: int):
    """n pairs of at most lq and lt bases whose lengths differ by at most
    r, each a mutated copy of the other, and two that leave the band."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a = generate_random_genome(int(rng.integers(1, lq + 1)), rng)
        b = mutate_sequence(a, max(1, len(a) // 20), rng)[:lt]
        pairs.append((a, b))
    a = generate_random_genome(lq, rng)
    return pairs + [(a, a[:max(0, lq - r - 1)]), ("", a[:min(lt, r)]),
                    (a[:30] + "NN", a[:30] + "NN")]


@pytest.mark.cuda
@pytest.mark.parametrize("r, smem, plan", [
    (7, None, ("warp-shared", 1, 4)),
    (40, None, ("warp-shared", 2, 4)),
    (72, None, ("warp-shared", 3, 4)),
    (100, None, ("warp-shared", 4, 4)),
    (150, None, ("warp-shared", 5, 4)),
    (200, None, ("warp-shared", 7, 4)),
    (255, None, ("warp-shared", 8, 4)),
    (100, 500, ("warp-device", 4, 4)),
    (300, None, ("block-shared", 0, 1)),
    (300, 500, ("block-device", 0, 1)),
])
def test_nw_diag_plans_match_plain_version(r, smem, plan, cuda_device,
                                           monkeypatch):
    """B1 in each plan (a warp a problem with K = 1 to 8 slots a lane, q
    and t staged or read through L1; a block a problem, shared or
    device), scores and the whole traceback, against its plain version;
    SMEM_PER_BLOCK lowered to reach the device plans at small shapes."""
    if smem:
        monkeypatch.setattr(_build, "SMEM_PER_BLOCK", smem)
    assert nw_diag.nw_diag_plan(400, 420, r) == plan
    q, qlen, t, tlen = pair_batch(near_pairs(r, 37, 400, 420, r), 400, 420,
                                  cuda_device)
    got = nw_diag.banded_nw_diag(q, qlen, t, tlen, r)
    torch.cuda.synchronize()
    want = nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 5, 9, 17, 33, 65, 129, 513, 1100])
def test_myers_lanes_and_passes_match_plain_version(words, cuda_device):
    """Batches whose padded query reaches each lane count G = 1..32 and
    one, two or three passes."""
    rng = np.random.default_rng(words)
    Lq = 32 * words
    pairs = []
    for n in (Lq, Lq - 1, max(1, Lq - 40), min(33, Lq), 1, 0):
        a = generate_random_genome(n, rng)
        pairs.append((a, mutate_sequence(a[:300], 12, rng)))
    args = pair_batch(pairs, Lq, 320, cuda_device)
    got = myers.myers_bottom_row(*args)
    torch.cuda.synchronize()
    want = myers.myers_bottom_row_torch(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def poa_windows(n: int, blen: int, depth: int, L: int, seed: int):
    rng = np.random.default_rng(seed)
    seqs = np.full((n, depth, L), -1, np.int32)
    lens = np.zeros((n, depth), np.int32)
    for wi in range(n):
        b = generate_random_genome(blen, rng)
        for si in range(depth):
            s = mutate_sequence(b, max(3, blen // 30), rng)[:L]
            seqs[wi, si, :len(s)] = encode(s)
            lens[wi, si] = len(s)
    return seqs, (seqs >= 0).astype(np.int32), lens, \
        np.full(n, depth, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("bs_kw, banded, variant, ring, scores", [
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "warp",
     8, PoaScores()),
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "warp", 0,
     PoaScores()),
    (dict(max_sequence_size=100, max_sequences_per_poa=5, band_width=24),
     True, "warp", 2, PoaScores()),
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "block",
     8, PoaScores()),
    (dict(max_sequence_size=600, max_sequences_per_poa=4), False, "block",
     8, PoaScores()),
    (dict(max_sequence_size=600, max_sequences_per_poa=4), False, "block",
     0, PoaScores()),
    # more pred slots than a warp carries in flight, and 8-byte plane words
    (dict(max_sequence_size=100, max_sequences_per_poa=5,
          max_pred_per_node=72), False, "warp", 8, PoaScores()),
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "warp", 8,
     WIDE),
    (dict(max_sequence_size=100, max_sequences_per_poa=5, band_width=24),
     True, "block", 8, WIDE),
])
def test_nwtb_variants_match_plain_version(bs_kw, banded, variant, ring,
                                           scores, cuda_device,
                                           monkeypatch):
    """B5 as a warp and as a block a window (BLOCK_WINDOWS set so that 24
    windows take the one asked for), with and without the ring (RING_ROWS),
    with 72 pred slots and with 8-byte plane words, against its plain
    version at every launch of a lockstep run."""
    monkeypatch.setattr(poa_nwtb, "BLOCK_WINDOWS",
                        0 if variant == "warp" else 1 << 20)
    monkeypatch.setattr(poa_nwtb, "RING_ROWS", ring)
    bs = BatchSize(**bs_kw)
    arrays = poa_windows(24, bs.max_sequence_size - 10,
                         bs.max_sequences_per_poa, bs.padded_seq, 3)
    seen = []

    def checked(*args):
        W, L = args[0].shape
        N, P = args[6].shape[1:]
        plan = poa_nwtb.nwtb_plan(W, N, P, L, args[11],
                                  poa_nwtb.nwtb_word_bytes(N, L, args[10]))
        assert plan[0] == variant and plan[2] == ring
        got = poa_nwtb.graph_nw_traceback(*args)
        torch.cuda.synchronize()
        want = poa_nwtb.graph_nw_traceback_torch(*args)
        seen.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        return got

    monkeypatch.setattr(poa_window, "graph_nw_traceback", checked)
    poa_window.run_windows(bs, scores, banded,
                           *(torch.from_numpy(a).to(cuda_device)
                             for a in arrays))
    assert seen and all(seen)


@pytest.mark.cuda
@pytest.mark.parametrize("P, variant", [(65, "warp"), (130, "warp"),
                                        (65, "block"), (300, "block")])
@pytest.mark.parametrize("scores", [PoaScores(), WIDE])
def test_fan_in_graph_on_card(P, variant, scores, cuda_device, monkeypatch):
    """Preds past the 64 (a warp) or 2 x 128 (a block) slots carried in
    flight, on 4- and 8-byte words: B5 equals its plain version."""
    monkeypatch.setattr(poa_nwtb, "BLOCK_WINDOWS",
                        0 if variant == "warp" else 1 << 20)
    args = [torch.from_numpy(a) for a in fan_in(P, 40, 12)]
    want = poa_nwtb.graph_nw_traceback(*args, scores)
    got = poa_nwtb.graph_nw_traceback(
        *(a.to(cuda_device) for a in args), scores)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cli_poa_shapes_run_device_variants(cuda_device):
    """Windows of 2,048-base sequences at cli poa's sizes: B8 one window
    a block (its first design's device variant), B5 a block a window;
    every step of the lockstep route equal to the plain versions."""
    bs = BatchSize(max_sequence_size=2_048, max_sequences_per_poa=3)
    assert poa_consensus.consensus_plan(
        2, bs.padded_nodes, 4, bs.max_consensus_size) == ("warp-shared", 1)
    arrays = [torch.from_numpy(a).to(cuda_device)
              for a in poa_windows(2, 2_040, 3, bs.padded_seq, 4)]
    got = poa_window.run_windows(bs, PoaScores(), False, *arrays)
    want = poa_window.run_windows(bs, PoaScores(), False, *arrays,
                                  plain=True)
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a, b)
