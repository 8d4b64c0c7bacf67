"""The CIGAR kernel's plain version (claragenomicsanalysis_tpu_torch/ops/
cigar.py) against ``utils.cigar.path_to_cigar`` on the CPU, on paths packed
as B2 packs them and cut into segments; the packed route of the decoder,
Hirschberg and the aligner (``Aligner.get_cigars``) against the list route.
The ``cuda`` cases hold the kernel (csrc/cigar.cu) to the same on the card
and skip without one."""

import numpy as np
import pytest
import torch

from claragenomicsanalysis_tpu_torch.align import hirschberg
from claragenomicsanalysis_tpu_torch.core.status import StatusType
from claragenomicsanalysis_tpu_torch.models.aligner import create_aligner
from claragenomicsanalysis_tpu_torch.ops import cigar, nw_diag, nw_row
from claragenomicsanalysis_tpu_torch.ops import tb_decode
from claragenomicsanalysis_tpu_torch.utils import profiling
from claragenomicsanalysis_tpu_torch.utils.cigar import path_to_cigar
from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs


def _words(codes: np.ndarray) -> np.ndarray:
    """16 codes a word, code k at bits 2 (k & 15), as int32 bit patterns."""
    w = (codes.reshape(-1, 16).astype(np.int64)
         << (2 * np.arange(16))).sum(1)
    return np.where(w >= 2**31, w - 2**32, w).astype(np.int32)


def pack(paths, cuts, offsets, rng):
    """``paths`` (code lists) as ops.cigar's segments: path p cut before
    each position of ``cuts[p]``, its segment k starting at slot
    ``offsets[p][k]`` of a row of its own whose other slots hold random
    codes (the kernel must not read them)."""
    words, base, first, end, path_seg = [], [], [], [], [0]
    n_words = 0
    for p, c, o in zip(paths, cuts, offsets):
        bounds = [0, *c, len(p)]
        for k, (a, b) in enumerate(zip(bounds, bounds[1:])):
            row = rng.integers(0, 4, 16 * ((o[k] + b - a + 15) // 16 + 1))
            row[o[k]:o[k] + b - a] = p[a:b]
            base.append(n_words)
            first.append(o[k])
            end.append(o[k] + b - a)
            words.append(_words(row))
            n_words += len(words[-1])
        path_seg.append(path_seg[-1] + len(bounds) - 1)
    i64 = torch.int64
    return (torch.from_numpy(np.concatenate([np.zeros(0, np.int32)]
                                            + words)),
            torch.tensor(base, dtype=i64), torch.tensor(first, dtype=i64),
            torch.tensor(end, dtype=i64), torch.tensor(path_seg, dtype=i64))


def random_path(rng, n, indel=0.05, mismatch=0.05) -> list[int]:
    return rng.choice(4, n, p=[1 - indel - mismatch, mismatch, indel / 2,
                               indel / 2]).tolist()


def _case(name: str):
    """-> (paths, cuts, offsets) of a named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "empty":
        return [[]], [[]], [[0]]
    if name == "one_move":
        return [[0], [3]], [[], []], [[0], [15]]
    if name == "five_digit_run":
        return [[0] * 12_345, [1] * 10_000 + [2]], [[], []], [[7], [0]]
    if name == "run_across_a_word":
        # slots 14-17 and 30-33 straddle word boundaries; every run of the
        # second path ends on one
        return ([[0] * 4 + [2] * 5, [3] * 16 + [2] * 16 + [0]],
                [[], []], [[14], [16]])
    if name == "run_across_segments":
        # an I run cut by a segment boundary, then a segment that ends one
        # M run which the next continues, then an empty segment
        p = [0] * 5 + [2] * 6 + [0] * 9 + [1] * 3 + [0] * 2
        return [p], [[8, 14, 14, 21]], [[3, 31, 0, 9, 17]]
    if name == "partial_word":
        return [[0] * 20 + [3] * 3, [1] * 5], [[], [3]], [[5], [0, 40]]
    if name == "random_5pct":
        paths = [random_path(rng, int(n)) for n in rng.integers(1, 900, 24)]
        cuts = [sorted(rng.integers(0, len(p) + 1, int(rng.integers(0, 5))))
                for p in paths]
        offsets = [rng.integers(0, 48, len(c) + 1).tolist() for c in cuts]
        return paths, cuts, offsets
    if name == "empty_among_others":
        p = random_path(rng, 300)
        return ([p, [], p[:40], [], [2]], [[100], [], [], [0, 0], []],
                [[0, 5], [9], [33], [1, 2, 3], [31]])
    raise KeyError(name)


CASES = ("empty", "one_move", "five_digit_run", "run_across_a_word",
         "run_across_segments", "partial_word", "random_5pct",
         "empty_among_others")


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_plain_equals_path_to_cigar(name, extended):
    paths, cuts, offsets = _case(name)
    args = pack(paths, cuts, offsets, np.random.default_rng(1))
    got = cigar.cigar_strings(*args, extended=extended)
    assert got == [path_to_cigar(p, extended=extended) for p in paths]


def test_counters_and_no_paths():
    paths, cuts, offsets = _case("run_across_segments")
    args = pack(paths * 3, cuts * 3, offsets * 3, np.random.default_rng(2))
    with profiling.stage_times() as st:
        got = cigar.cigar_strings(*args)
    text = sum(len(s) + 1 for s in got)
    assert st.counters == {"cigar.paths": 3, "cigar.segments": 15,
                           "cigar.bytes": text, "readback": 1}
    none = pack([], [], [], np.random.default_rng(3))
    assert cigar.cigar_strings(*none) == []
    assert cigar.cigar_text(*none).numel() == 0


def test_rejects_wrong_types():
    words, base, first, end, path_seg = pack([[0, 1]], [[]], [[0]],
                                             np.random.default_rng(4))
    with pytest.raises(ValueError, match="words"):
        cigar.cigar_text(words.long(), base, first, end, path_seg)
    with pytest.raises(ValueError, match="seg_first"):
        cigar.cigar_text(words, base, first.int(), end, path_seg)
    with pytest.raises(ValueError, match="path_seg"):
        cigar.cigar_text(words, base, first, end, path_seg.int())


def _banded(kernel: str, n=12, L=96, r=32, seed=5):
    """A batch of noisy pairs through the plain banded NW of ``kernel``:
    -> (tb, qlen, tlen, r)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(n):
        t = rng.integers(0, 4, int(rng.integers(1, L - 16)))
        q = t.copy()
        for _ in range(len(t) // 12):
            k = int(rng.integers(0, len(q)))
            q = (np.delete(q, k) if rng.random() < 0.5
                 else np.insert(q, k, rng.integers(0, 4)))
        qs.append("".join("ACGT"[c] for c in q))
        ts.append("".join("ACGT"[c] for c in t))
    qs.append("")
    ts.append("")                                     # an empty pair
    q, ql, t, tl = (torch.from_numpy(a) for a in pack_pairs(qs, ts, L, L))
    fn = nw_row.banded_nw_row if kernel == "row" else nw_diag.banded_nw_diag
    _, tb = fn(q, ql, t, tl, r)
    return tb, ql, tl, r


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("kernel", ["diag", "row"])
def test_decode_packed_equals_the_list_route(kernel, extended):
    """decode_packed's cut words give every path's CIGAR, in either
    layout, the empty path included; rows added out of order come back in
    path order, and unkept paths are left out."""
    tb, ql, tl, r = _banded(kernel)
    lists = tb_decode.traceback_paths_device(tb, ql, tl, r, kernel)
    words, first = tb_decode.decode_packed(tb, ql, tl, r, kernel)
    assert words.shape[1] < tb_decode.DECODERS[kernel](tb, ql, tl, r)[0] \
        .shape[1]
    B = len(lists)
    paths = tb_decode.PackedPaths(B, "cpu")
    half = np.arange(B) % 2 == 0
    for rows in (np.flatnonzero(~half), np.flatnonzero(half)):
        sel = torch.from_numpy(rows)
        paths.add(rows, words[sel], first[sel])
    keep = np.ones(B, bool)
    keep[3] = False
    got = cigar.cigar_strings(*paths.segments(keep), extended=extended)
    assert got == [path_to_cigar(p, extended) for b, p in enumerate(lists)
                   if keep[b]]
    assert got[-1] == ""


def _long_pairs(n=4, L=700, seed=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, 4, L)
        q = np.array(random_path(rng, L, 0.0, 0.0))      # unrelated codes
        q[: L // 2] = t[: L // 2]
        out.append(("".join("ACGT"[c] for c in q[: L - 37]),
                    "".join("ACGT"[c] for c in t)))
    return out


@pytest.mark.parametrize("extended", [False, True])
def test_hirschberg_packed_equals_the_list_join(extended):
    pairs = _long_pairs()
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    lists, _ = hirschberg.hirschberg_align_batch(qs, ts, "cpu")
    with profiling.stage_times() as st:
        packed = hirschberg.hirschberg_align_packed(qs, ts, "cpu")
        got = cigar.cigar_strings(*packed.segments(np.ones(len(qs), bool)),
                                  extended=extended)
    assert got == [path_to_cigar(p, extended) for p in lists]
    c = st.counters
    assert c["hirschberg.pairs"] == c["cigar.paths"] == len(qs)
    assert c["cigar.segments"] >= len(qs) * (700 - 37) // 32
    assert "tb.unpack" not in st.calls and "hirschberg.join" not in st.calls


@pytest.mark.parametrize("kernel", ["diag", "row"])
def test_get_cigars_equals_get_alignments(kernel):
    """Both routes of one aligner, a pair too long for it included (its
    CIGAR is empty), on spans that go banded and to Hirschberg."""
    pairs = _long_pairs(3, 600) + [("ACGT" * 300, "ACGT" * 10),
                                   ("ACGTTGCA", "ACGTGCA"), ("", "")]
    al = create_aligner(1024, 1024, len(pairs), band_radius=64,
                        algorithm="myers", device="cpu", kernel=kernel)
    for q, t in pairs:
        al.add_alignment(q, t)
    want = [(a.status, a.convert_to_cigar(True)
             if a.status == StatusType.SUCCESS else "")
            for a in al.get_alignments()]
    with profiling.stage_times() as st:
        got = al.get_cigars(extended=True)
    assert got == want
    assert [s for s, _ in got].count(StatusType.SUCCESS) == len(pairs) - 1
    c = st.counters
    assert c["cigar.paths"] == len(pairs) - 1
    # the three long pairs and the too-long one (cut to 1,024, its status
    # failed) went to Hirschberg; each kept leaf is a segment
    assert c["hirschberg.pairs"] == 4
    assert c["cigar.segments"] > c["cigar.paths"] + 3 * 10
    assert "tb.unpack" not in st.calls
    al.reset()
    assert al.get_cigars() == []


@pytest.mark.parametrize("algorithm", ["ukkonen", "hirschberg-myers",
                                       "banded-escalate"])
def test_get_cigars_refuses_other_algorithms(algorithm):
    al = create_aligner(64, 64, 1, algorithm=algorithm, device="cpu")
    al.add_alignment("ACGT", "ACGT")
    with pytest.raises(ValueError, match="myers"):
        al.get_cigars()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CIGAR kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_path_to_cigar(name, extended):
    _card()
    paths, cuts, offsets = _case(name)
    args = pack(paths, cuts, offsets, np.random.default_rng(1))
    with profiling.stage_times() as st:
        got = cigar.cigar_strings(*(a.cuda() for a in args),
                                  extended=extended)
    assert got == [path_to_cigar(p, extended=extended) for p in paths]
    assert st.launches() == {"cigar": 2}
    text = cigar.cigar_text(*(a.cuda() for a in args), extended=extended)
    assert torch.equal(text.cpu(), cigar.cigar_text_torch(*args, extended))


@pytest.mark.cuda
def test_kernel_on_many_long_paths():
    """1,024 paths of up to 12,000 moves, cut into leaves of about 40
    moves, as Hirschberg cuts them."""
    _card()
    rng = np.random.default_rng(7)
    paths = [random_path(rng, int(n)) for n in rng.integers(0, 12_000,
                                                            1024)]
    cuts = [list(range(40, len(p), 40)) for p in paths]
    offsets = [rng.integers(0, 2000, len(c) + 1).tolist() for c in cuts]
    args = pack(paths, cuts, offsets, rng)
    got = cigar.cigar_strings(*(a.cuda() for a in args))
    assert got == [path_to_cigar(p) for p in paths]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["diag", "row"])
def test_get_cigars_on_card_equals_cpu(kernel):
    _card()
    pairs = _long_pairs(8, 3000, seed=8) + _long_pairs(8, 400, seed=9)
    out = {}
    for dev in ("cpu", "cuda"):
        al = create_aligner(4096, 4096, len(pairs), band_radius=256,
                            algorithm="myers", device=dev, kernel=kernel)
        for q, t in pairs:
            al.add_alignment(q, t)
        out[dev] = al.get_cigars()
    assert out["cuda"] == out["cpu"]
