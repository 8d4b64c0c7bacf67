"""The warp plan of the port's row-layout banded NW (claragenomicsanalysis_
tpu_torch/csrc/nw_row.cu, B3): its plan chooser at every threshold, and a
numpy replay of the warp's rows, lane by lane, held byte for byte against
the plain PyTorch version and the JAX package's row kernel.

The replay follows the kernel's own steps: 32 lanes of K slots a problem,
tmp of the slots (the last slot's `up` the next lane's first value of the
row before, made from that lane's first tmp - k and this lane's scan, INF
on lane 31), the lane's minimum and running minimum of tmp - k, the warp's
inclusive min-scan by shuffles and its exclusive shift, the K values, the
first slot's `left` from the previous lane (INF on lane 0), the codes ORed
into a lane word and stored every fourth row, the target codes shifting a
slot a row with one entering, zeros past the problem's last packed row.
The CUDA kernel itself runs only on the card (the ``cuda`` tests and
``chip_smoke.py``); the DP is integer work, so every comparison is exact."""

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu.ops.nw_band_pallas import banded_nw_pallas
from claragenomicsanalysis_tpu.utils.genomeutils import encode
from claragenomicsanalysis_tpu_torch.ops import _build, nw_diag, nw_row

INF = nw_row.INF
INT_MAX = 2**31 - 1


def fetch(s, pos, n):
    """csrc/band_warp.cuh fetch: the base at pos - 1 of a sequence of n
    (clamped) and whether pos lies in 1..n."""
    ok = (pos >= 1) & (pos <= n)
    p = np.clip(pos - 1, 0, max(n - 1, 0))
    raw = s[p] if n else np.zeros_like(pos)
    return raw.astype(np.int64), ok


def q_code(f):
    raw, ok = f
    return np.where(ok & (raw >= 0), raw, -1)


def t_code(f):
    raw, ok = f
    return np.where(ok & (raw >= 0), raw, -2)


def warp_replay(q, qlen, t, tlen, r):
    """csrc/nw_row.cu's warp plan (WarpRows) on numpy arrays -> (scores,
    tb) as the kernel writes them."""
    B, Lq = q.shape
    Lt = t.shape[1]
    W = nw_row.band_width_row(r)
    K = -(-W // 32)
    R4 = nw_row.tb_rows(Lq)
    scores = np.zeros(B, np.int32)
    tb = np.full((R4, B, W), 0xAB, np.uint8)   # every byte must be written
    lane = np.arange(32)[:, None]
    c = np.arange(K)[None, :]
    u0 = lane * K
    k = u0 + c
    nreal = np.minimum(K, W - u0[:, 0])
    for b in range(B):
        ql, tl = int(qlen[b]), int(tlen[b])
        band_ok = abs(ql - tl) <= r
        kf = r + tl - ql if band_ok else -1
        rows_end = (ql + 3) & ~3
        prev = np.where((k <= 2 * r) & (k - r >= 0) & (k - r <= tl), k - r,
                        INF).astype(np.int64)
        jt0 = 1 + u0 - r
        tv = t_code(fetch(t[b], jt0 + c, Lt))
        qc = q_code(fetch(q[b], np.array(1), Lq))
        acc = np.zeros((32, K), np.int64)
        score = 0
        nup = np.concatenate([prev[1:, :1], [[INF]]])   # lane 31: INF
        for i in range(1, rows_end + 1):
            up = np.concatenate([prev[:, 1:], nup], 1)
            klo = -jt0
            khi = np.minimum(tl - jt0, 2 * r - u0) if i <= ql else \
                np.full_like(jt0, -1)
            valid = (c >= klo) & (c <= khi)
            sub = (qc != tv).astype(np.int64)
            diag = prev + sub
            x = np.minimum(diag, up + 1)
            x = np.where(jt0 + c == 0, i, x)
            x = np.where(valid, x, INF)
            y = x - k
            run = np.minimum.accumulate(y, axis=1)
            incl = y.min(1)                           # the tree
            o = 1
            while o < 32:                 # __shfl_up_sync scan
                n = np.concatenate([incl[:o], incl[:-o]])
                incl = np.where(np.arange(32) >= o, np.minimum(incl, n),
                                incl)
                o <<= 1
            excl = np.concatenate([[INT_MAX], incl[:-1]])
            # the next row's up of the last slot: the next lane's first
            # value, from its first tmp - k and this lane's inclusive scan
            r0 = np.where(valid[:, 0], y[:, 0], np.iinfo(np.int32).min)
            r0 = np.concatenate([r0[1:], r0[-1:]])     # __shfl_down_sync
            nup = np.where((np.arange(32) == 31)
                           | (r0 == np.iinfo(np.int32).min), INF,
                           np.minimum(incl, r0) + u0[:, 0] + K)[:, None]
            cur = np.where(valid, np.minimum(excl[:, None], run) + k, INF)
            left0 = np.concatenate([[[INF]], cur[:-1, -1:]])  # lane 0: INF
            left = np.concatenate([left0, cur[:, :-1]], 1)
            code = np.where(cur == diag, sub,
                            np.where(cur == left + 1, 3, 2))
            acc |= code << (2 * ((i - 1) & 3))
            if i == ql and band_ok:
                score = int(cur.reshape(-1)[kf])
            if (i - 1) & 3 == 3:
                for ln in range(32):
                    if nreal[ln] > 0:
                        s0 = ln * K
                        tb[(i - 1) >> 2, b, s0:s0 + nreal[ln]] = \
                            acc[ln, :nreal[ln]]
                acc[:] = 0
            prev = cur
            jt0 = jt0 + 1
            tv = np.concatenate(
                [tv[:, 1:], t_code(fetch(t[b], jt0 + K - 1, Lt))], 1)
            qc = q_code(fetch(q[b], np.array(i + 1), Lq))
        scores[b] = (tl if ql == 0 else score) if band_ok else INF
        for rr in range(rows_end >> 2, R4):
            tb[rr, b] = 0
    return scores, tb.view(np.int8)


#: a radius for each lanes-a-thread count K = 1..8 of the warp plan (W =
#: round_up(2r + 1, 8) <= 32 K), W not a multiple of 32 with idle lanes at
#: most of them
RADII_BY_K = {1: 1, 2: 16, 3: 40, 4: 60, 5: 72, 6: 90, 7: 100, 8: 127}


def edge_batch(seed: int, r: int):
    """Seeded pairs at the band's edges: qlen = 0, tlen = 0, both 0,
    |qlen - tlen| = r and r + 1, N bases, and mutated pairs."""
    rng = np.random.default_rng(seed)
    L = r + 24
    a = rng.integers(0, 4, L + r + 2)
    txt = "ACGT"

    def s(x):
        return "".join(txt[v] for v in x)

    pairs = [("", s(a[:5])), (s(a[:7]), ""), ("", ""),
             (s(a[:L]), s(a[:L - r])), (s(a[:L]), s(a[:L - r - 1])),
             (s(a[:min(r, 10)]), s(a[:min(r, 10) + r])),
             (s(a[:9]) + "NN" + s(a[11:20]), s(a[:9]) + "NN" + s(a[11:21]))]
    for _ in range(3):
        m = a[:L].copy()
        hit = rng.random(L) < 0.1
        m[hit] = (m[hit] + 1) % 4
        m = np.delete(m, rng.choice(L, min(3, r), replace=False))
        pairs.append((s(a[:L]), s(m)))
    Lq = max(len(x) for x, _ in pairs) + 5
    Lt = max(len(y) for _, y in pairs) + 3
    q = np.stack([encode(x, Lq) for x, _ in pairs])
    t = np.stack([encode(y, Lt) for _, y in pairs])
    qlen = np.array([len(x) for x, _ in pairs], np.int32)
    tlen = np.array([len(y) for _, y in pairs], np.int32)
    return q, qlen, t, tlen


@pytest.mark.parametrize("K", sorted(RADII_BY_K))
def test_warp_replay_equals_plain_version_and_jax(K):
    r = RADII_BY_K[K]
    q, qlen, t, tlen = edge_batch(700 + K, r)
    W = nw_row.band_width_row(r)
    assert -(-W // 32) == K
    assert nw_row.nw_row_plan(q.shape[1], t.shape[1], r)[:2] == \
        ("warp-shared", K)
    s_w, tb_w = warp_replay(q, qlen, t, tlen, r)
    s_p, tb_p = nw_row.banded_nw_row_torch(
        *(torch.from_numpy(x) for x in (q, qlen, t, tlen)), r)
    np.testing.assert_array_equal(s_w, s_p.numpy())
    np.testing.assert_array_equal(tb_w, tb_p.numpy())
    assert (s_w == INF).sum() >= 1 and (s_w < INF).sum() >= 6
    s_j, tb_j = banded_nw_pallas(q, qlen, t, tlen, r, interpret=True)
    np.testing.assert_array_equal(s_w, np.asarray(s_j))
    tb_j = np.asarray(tb_j)
    for b, n in enumerate(qlen):    # the rows the problem reaches
        np.testing.assert_array_equal(tb_w[: (n + 3) // 4, b],
                                      tb_j[: (n + 3) // 4, b], err_msg=b)


@pytest.mark.parametrize("r, plan", [
    (RADII_BY_K[1], ("warp-shared", 1, 4, 128)),   # W = 8
    (15, ("warp-shared", 1, 4, 128)),              # W = 32
    (RADII_BY_K[2], ("warp-shared", 2, 4, 128)),   # W = 40
    (RADII_BY_K[3], ("warp-shared", 3, 4, 128)),   # W = 88
    (RADII_BY_K[4], ("warp-shared", 4, 4, 128)),   # W = 128
    (RADII_BY_K[5], ("warp-shared", 5, 4, 128)),   # W = 152: ukkonen_row
    (RADII_BY_K[6], ("warp-shared", 6, 4, 128)),   # W = 184
    (RADII_BY_K[7], ("warp-shared", 7, 4, 128)),   # W = 208
    (127, ("warp-shared", 8, 4, 128)),             # W = 256: the widest
    (128, ("block-shared", 1, 1, 288)),            # W = 264: a block
])
def test_nw_row_plan_by_band(r, plan):
    """A warp a problem up to W = 256 band lanes, K the fewest lanes a
    thread with 32 K >= W, four problems a block at the main path's
    shapes; wider bands a block a problem.  No warp plan takes scratch."""
    assert nw_row.nw_row_plan(10_000, 10_008, r) == plan
    W = nw_row.band_width_row(r)
    variant, K, n, threads = plan
    if variant.startswith("warp"):
        assert 32 * K >= W > 32 * (K - 1) and threads == 32 * n
    assert nw_row.nw_row_scratch_bytes(10_000, 10_008, r) == 0


@pytest.mark.parametrize("lq_lt, plan", [
    (58_112, ("warp-shared", 5, 4, 128)),  # 4 x 58,112 = 232,448 B
    (58_128, ("warp-shared", 5, 2, 64)),
    (116_224, ("warp-shared", 5, 2, 64)),
    (116_240, ("warp-shared", 5, 1, 32)),
    (232_448, ("warp-shared", 5, 1, 32)),
    (232_464, ("warp-device", 5, 4, 128)),  # q and t read through L1
])
def test_nw_row_warp_plan_stages_while_q_and_t_fit(lq_lt, plan):
    """A warp's copy of q and t (nw_diag_stage_bytes, B1's rule) sets the
    problems a block: 4, 2 or 1 whose copies fit 227 KB, else 4 a block
    reading q and t through L1; none takes device scratch."""
    Lq = lq_lt // 32 * 16
    assert nw_diag.nw_diag_stage_bytes(Lq, lq_lt - Lq) == lq_lt
    assert nw_row.nw_row_plan(Lq, lq_lt - Lq, 72) == plan
    assert nw_row.nw_row_scratch_bytes(Lq, lq_lt - Lq, 72) == 0


def test_nw_row_block_plans_past_a_block():
    """Wide bands keep the block body: shared while its row, q and t fit,
    the device variant (a scratch row a problem) past it."""
    smem = _build.SMEM_PER_BLOCK
    r = 600                                       # W = 1,208
    fit = smem - 4 * (nw_row.band_width_row(r) + 1) - 128
    assert nw_row.nw_row_plan(fit - 8, 8, r) == ("block-shared", 2, 1, 608)
    assert nw_row.nw_row_scratch_bytes(fit - 8, 8, r) == 0
    assert nw_row.nw_row_plan(fit - 7, 8, r) == ("block-device", 2, 1, 608)
    assert nw_row.nw_row_scratch_bytes(fit - 7, 8, r) == 4 * 1_209


@pytest.mark.cuda
def test_every_row_plan_equals_plain_version_on_card():
    """Each K of the warp plan (staged and through L1) and both block
    variants against the plain version on the card, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for K, r in sorted(RADII_BY_K.items()) + [(0, 128)]:
        q, qlen, t, tlen = (torch.from_numpy(x).cuda()
                            for x in edge_batch(800 + K, r))
        want = nw_row.banded_nw_row_torch(q, qlen, t, tlen, r)
        for limit in (None, 40):
            saved = _build.SMEM_PER_BLOCK
            if limit is not None:
                _build.SMEM_PER_BLOCK = limit
            try:
                got = nw_row.banded_nw_row(q, qlen, t, tlen, r)
                torch.cuda.synchronize()
            finally:
                _build.SMEM_PER_BLOCK = saved
            assert torch.equal(got[0], want[0]), (K, limit)
            assert torch.equal(got[1], want[1]), (K, limit)
