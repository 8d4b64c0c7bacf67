"""B2's plan chooser (``ops.tb_decode.tb_decode_plan``) at its thresholds,
and the invariant the staged plan of ``csrc/tb_decode.cu`` rests on: the
packed row a walk reads never rises and falls by at most one a step, in
both layouts and on INF-score garbage walks too, so a ring of two chunks of
the planned rows, streamed from the walk's first row down, always holds the
row it reads next.

The walk is replayed here problem by problem the way the staged kernel
walks it (the chunk of rows it holds, the step at which it moves on to the
next chunk), recording every row it reads, and its packed path must equal
the plain version's.
"""

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu_torch.ops import nw_diag, nw_row, tb_decode
from claragenomicsanalysis_tpu_torch.ops.tb_decode import (
    CHUNK_ROWS, RING_BYTES, SMS, STAGE_MAX_WIDTH, STAGE_MIN_ROWS,
    THREAD_PROBLEMS, tb_decode_plan)


@pytest.mark.parametrize("B, R4, W, layout, want", [
    # the main paths: ukkonen's largest launch (diag, W = 80), the row
    # route's (W = 152), myers' Hirschberg base case (18 rows)
    (449, 5004, 80, "diag", ("staged-16", 2, 64)),
    (449, 2500, 152, "row", ("staged-8", 2, 64)),
    (133_138, 20, 40, "diag", ("thread", THREAD_PROBLEMS, 0)),
    # the row threshold
    (600, STAGE_MIN_ROWS, 88, "row", ("staged-8", 4, 64)),
    (600, STAGE_MIN_ROWS - 1, 88, "row", ("thread", THREAD_PROBLEMS, 0)),
    # the width threshold, and a chunk of fewer rows where two would pass
    # RING_BYTES
    (1, 1000, STAGE_MAX_WIDTH, "diag", ("staged-16", 1, 32)),
    (1, 1000, STAGE_MAX_WIDTH + 8, "diag", ("thread", THREAD_PROBLEMS, 0)),
    (4 * SMS, 1000, 264, "row", ("staged-8", 4, 62)),
    # a width that is no multiple of 8 cannot be copied in 8-byte pieces
    (300, 1000, 84, "diag", ("thread", THREAD_PROBLEMS, 0)),
    # problems a block: the most (4, 2, 1) that still give every SM a block
    (4 * SMS - 1, 1000, 80, "diag", ("staged-16", 2, 64)),
    (2 * SMS - 1, 1000, 80, "diag", ("staged-16", 1, 64)),
])
def test_tb_decode_plan_thresholds(B, R4, W, layout, want):
    assert tb_decode_plan(B, R4, W, layout) == want


def test_tb_decode_plan_sends_every_shape_somewhere():
    for layout in ("diag", "row"):
        for W in (8, 16, 24, 80, 152, 512, 520, 4208, 65_672, 140_008):
            for R4 in (0, 1, 63, 64, 5004):
                variant, problems, rows = tb_decode_plan(300, R4, W, layout)
                if variant == "thread":
                    assert (problems, rows) == (THREAD_PROBLEMS, 0)
                    continue
                copy = int(variant.split("-")[1])
                assert W % copy == 0 and 1 <= problems <= 4
                assert 1 <= rows <= CHUNK_ROWS
                assert 2 * rows * W <= RING_BYTES
    with pytest.raises(ValueError, match="layout"):
        tb_decode_plan(1, 100, 80, "col")


def staged_walk(tb, qlen, tlen, r, layout, rows):
    """The staged kernel's walk of every problem, one chunk of ``rows`` rows
    at a time from the first row read down: -> (packed, start) as the
    decoders return them, and each problem's rows in the order it read
    them.  Asserts that each row read lies in the chunk the ring holds
    then, after moving on one chunk at most."""
    tbu = tb.view(torch.uint8).numpy()
    R4, B, W = tbu.shape
    TL = (tb_decode.path_slots(R4) if layout == "diag"
          else tb_decode.path_slots_row(R4, r))
    packed = np.zeros((B, TL // 16), np.int64)
    start = np.zeros(B, np.int64)
    read = []
    for b in range(B):
        i, j, k = int(qlen[b]), int(tlen[b]), TL
        if layout == "diag":
            top = min(max((i + j) >> 2, 0), R4 - 1)
        else:
            top = min(max((i - 1) >> 2, 0), R4 - 1)
        chunk_hi = top
        lo = max(chunk_hi - rows + 1, 0)
        mine = []
        while (i > 0 or j > 0) and k > 0:
            code = 3
            if i > 0:
                if layout == "diag":
                    d = i + j
                    lane = min(max((r + j - i - ((d + r) & 1)) >> 1, 0),
                               W - 1)
                    row, shift = min(max(d >> 2, 0), R4 - 1), 2 * (d & 3)
                else:
                    lane = min(max(r + j - i, 0), W - 1)
                    row, shift = min((i - 1) >> 2, R4 - 1), 2 * ((i - 1) & 3)
                if row < lo:        # the kernel moves on to the next chunk
                    chunk_hi, lo = lo - 1, max(lo - rows, 0)
                assert lo <= row <= chunk_hi, "the ring lacks the next row"
                mine.append(row)
                code = (int(tbu[row, b, lane]) >> shift) & 3
            k -= 1
            packed[b, k >> 4] |= code << (2 * (k & 15))
            i -= code != 3
            j -= code != 2
        start[b] = k
        read.append(mine)
    packed = np.where(packed >= 2**31, packed - 2**32, packed)
    return packed.astype(np.int32), start.astype(np.int32), read


@pytest.mark.parametrize("layout", ["diag", "row"])
@pytest.mark.parametrize("r", [3, 8, 31])
def test_staged_walk_rows_never_rise(layout, r):
    rng = np.random.default_rng(r)
    B, L = 12, 300
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = np.full((B, L + 16), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    qlen = np.full(B, L, np.int32)
    for b in range(B):
        s = q[b].copy()
        sub = rng.random(L) < 0.05
        s[sub] = (s[sub] + 1) % 4
        s = np.delete(s, rng.choice(L, 4, replace=False))
        s = np.insert(s, rng.choice(len(s), 6), rng.integers(0, 4, 6))
        t[b, :len(s)] = s
        tlen[b] = len(s)
    # INF-score rows: lengths far outside the band, a short query
    tlen[0], tlen[1], qlen[2] = 20, L + 16, 7
    nw = nw_diag.banded_nw_diag_torch if layout == "diag" else \
        nw_row.banded_nw_row_torch
    plain = tb_decode.decode_diag_torch if layout == "diag" else \
        tb_decode.decode_row_torch
    args = [torch.from_numpy(a) for a in (q, qlen, t, tlen)]
    scores, tb = nw(*args, r)
    assert int((scores >= nw_diag.INF).sum()) >= 2     # garbage walks
    # and one problem on random bytes
    tb[:, 3] = torch.from_numpy(rng.integers(-128, 128, tb[:, 3].shape)
                                .astype(np.int8))
    rows = 5        # many chunks a walk
    packed, start, read = staged_walk(tb, qlen, tlen, r, layout, rows)
    want_p, want_s = plain(tb, args[1], args[3], r)
    np.testing.assert_array_equal(packed, want_p.numpy())
    np.testing.assert_array_equal(start, want_s.numpy())
    for mine in read:
        steps = np.diff(np.array(mine, np.int64))
        assert (steps <= 0).all() and (steps >= -1).all()


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["diag", "row"])
@pytest.mark.parametrize("r", [8, 31, 64])
@pytest.mark.parametrize("plan", ["staged", "thread"])
def test_plans_match_plain_version_on_card(layout, r, plan, cuda_device,
                                           monkeypatch):
    """Each plan (the thread one forced by raising STAGE_MIN_ROWS), chunks of
    a few rows too, against the plain version on a tb with garbage walks."""
    rng = np.random.default_rng(r)
    B, L = 40, 1200
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = np.concatenate([q, rng.integers(0, 4, (B, 16)).astype(np.int8)], 1)
    tlen = np.full(B, L, np.int32) + rng.integers(-5, 6, B).astype(np.int32)
    qlen = np.full(B, L, np.int32)
    tlen[0], tlen[1], qlen[2] = 20, L + 16, 7
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, qlen, t, tlen)]
    nw = nw_diag.banded_nw_diag if layout == "diag" else nw_row.banded_nw_row
    dec = tb_decode.DECODERS[layout]
    plain = tb_decode.decode_diag_torch if layout == "diag" else \
        tb_decode.decode_row_torch
    _, tb = nw(*args, r)
    if plan == "thread":
        monkeypatch.setattr(tb_decode, "STAGE_MIN_ROWS", 1 << 30)
    want = plain(tb, args[1], args[3], r)
    for rows in (CHUNK_ROWS, 3):
        monkeypatch.setattr(tb_decode, "CHUNK_ROWS", rows)
        assert tb_decode.tb_decode_plan(B, *tb.shape[::2], layout)[0] \
            .startswith(plan)
        got = dec(tb, args[1], args[3], r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
