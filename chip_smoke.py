#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (claragenomicsanalysis_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one line or more each:
  1. environment, the card's name, power limit and SM clock, and the kernel
     build (nvcc, from csrc/ in this checkout);
  2. the banded-NW kernel against its plain PyTorch version on the card;
  3. the traceback-decode kernel against its plain version on the same tb;
  4. the port's ``align`` CLI on the bundled data against the golden file;
  5. the ``ukkonen`` main path, ``create_aligner(..., device="cuda")`` then
     ``align_all``, on 1,024 pairs of 2-10 kb at about 5 % divergence, with
     its checks, launch counts and the kernels' CUDA-event times inside the
     run; then each kernel against its plain version, outputs, times and
     bounds, at the path's largest chunk;
  6. the Myers kernel against its plain version on an edge batch and at its
     longest query (4,096 words);
  7. the ``myers`` main path on the same 1,024 pairs, with its checks,
     launch counts of all three kernels, routes and times; each kernel
     against its plain version, with times and bounds, at the inputs the
     path gave it: the banded kernels at its largest base-case launch
     (Hirschberg's leaves), the Myers kernel at the score pass and at its
     largest launch (Hirschberg's level 0); ``hirschberg-myers`` and
     ``banded-escalate`` on a subset;
  8. a short-read pass (0.5-1 kb) where ``myers`` and ``banded-escalate``
     take the banded re-run and must agree, and equal ``ukkonen`` wherever
     its score fits its radius (both are then the dense canonical path);
  9. ``cli align --algorithm myers|hirschberg-myers`` on the card and on the
     CPU, byte for byte.
Then one JSON line describing every kernel: under ``paths``, for each main
path (``ukkonen``, ``myers``), its launches in that run (counts zeroed just
before it, read just after) and the kernel's time, plain time and bound (the
least time the card could take for the same work) at that path's largest
launch, and the kernel's device time in that run (``run_ms``); at the top
level the sum of the launches, the largest difference from the plain
version seen anywhere, and the times of the path where the kernel spent the
most device time.  Last ``{"ok": true, "device":
{...}}``.  Any failed check raises,
so the script exits non-zero and prints no result; so does a machine with no
CUDA device.  The comparisons are exact: the DP is integer work.  The script
reaches only the port (``claragenomicsanalysis_tpu_torch``); its data is
made with NumPy from ``SEED``, and it checks at its end that no module of
``claragenomicsanalysis_tpu`` and no ``jax`` was loaded.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PAIRS = 1024           # main-path batch
N_SUBSET = 64            # pairs of phase 7 through the other two algorithms
N_SHORT = 512            # short-read pass
SEED = 0                 # every input is made from it
MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
SMS, INT32_LANES = 132, 64         # H100 SXM: SMs, int32 lanes per SM
# int32 operations per unit of work, counted for the bounds (see PERF.md)
OPS_PER_BAND_CELL = 7    # nw_diag: compare, 2 adds, 2 mins, 2 code selects
OPS_PER_WALK_STEP = 16   # tb_decode: address, extract, pack, i/j update
OPS_PER_MYERS_WORD = 27  # myers: one 32-bit word update (ops/myers_pallas.py)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def round8(n: int) -> int:
    return -(-max(n, 1) // 8) * 8


def pack(pairs, Lq=None, Lt=None):
    """Pairs of strings -> (q, qlen, t, tlen) NumPy arrays, -1 PAD, through
    the port's packing."""
    from claragenomicsanalysis_tpu_torch.utils.genomeutils import pack_pairs
    Lq = Lq or round8(max(len(a) for a, _ in pairs))
    Lt = Lt or round8(max(len(b) for _, b in pairs))
    return pack_pairs([a for a, _ in pairs], [b for _, b in pairs], Lq, Lt)


def to_str(codes) -> str:
    import numpy as np
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes().decode()


def mutate(codes, n: int, rng):
    """``codes`` (0-3) with ``n`` edits at distinct positions, each a
    substitution by another base, an insertion before, or a deletion."""
    import numpy as np
    pos = rng.choice(len(codes), min(n, len(codes)), replace=False)
    kind = rng.integers(0, 3, len(pos))
    out = codes.copy()
    sub = pos[kind == 0]
    out[sub] = (out[sub] + rng.integers(1, 4, len(sub))) % 4
    keep = np.ones(len(codes), dtype=bool)
    keep[pos[kind == 2]] = False
    ins = pos[kind == 1]
    out = np.insert(out, ins, rng.integers(0, 4, len(ins)).astype(out.dtype))
    keep = np.insert(keep, ins, True)
    return out[keep]


def cuda_ms(fn, reps: int):
    """Mean milliseconds of ``fn()`` on the card by CUDA events, and the
    last call's result."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def wrappers() -> dict:
    """The kernel wrappers, by kernel name; each counts its launches."""
    from claragenomicsanalysis_tpu_torch.ops import myers, nw_diag, tb_decode
    return {"nw_diag": nw_diag.banded_nw_diag,
            "tb_decode": tb_decode.decode_diag,
            "myers": myers.myers_bottom_row}


def zero_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def bound(ops: float, nbytes: float, sm_mhz: float) -> tuple[float, str]:
    """(ms, which binds): the larger of int32 operations over the card's
    int32 rate (132 SMs x 64 lanes x the SM clock) and bytes over its
    memory rate."""
    t_ops = ops / (SMS * INT32_LANES * sm_mhz * 1e6)
    t_bytes = nbytes / MEM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def zero_hirschberg() -> None:
    from claragenomicsanalysis_tpu_torch.align.hirschberg import \
        hirschberg_align_batch
    hirschberg_align_batch.pairs = hirschberg_align_batch.levels = 0


def read_hirschberg() -> tuple[int, int]:
    """(pairs aligned by Hirschberg, split levels run) since the last
    zero_hirschberg()."""
    from claragenomicsanalysis_tpu_torch.align.hirschberg import \
        hirschberg_align_batch
    return hirschberg_align_batch.pairs, hirschberg_align_batch.levels


def check_paths(results, pairs, what: str):
    """Every result SUCCESS, its path a global alignment over both
    sequences whose edits cost the reported distance."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.core.status import StatusType
    for res, (a, b) in zip(results, pairs):
        check(res.status == StatusType.SUCCESS,
              f"{what}: status {res.status.name}")
        p = np.asarray(res.path)
        check(int(np.isin(p, (0, 1, 2)).sum()) == len(a),
              f"{what}: query not used up")
        check(int(np.isin(p, (0, 1, 3)).sum()) == len(b),
              f"{what}: target not used up")
        check(int((p != 0).sum()) == res.edit_distance,
              f"{what}: cost != distance")


def phase_env() -> float:
    import torch
    from claragenomicsanalysis_tpu_torch.ops import _build
    print(f"phase 1 env: device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} python={sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    print(f"phase 1 clocks: max SM clock {sm_mhz:.0f} MHz -> int32 peak "
          f"{SMS} SMs x {INT32_LANES} lanes x {sm_mhz:.0f} MHz = "
          f"{SMS * INT32_LANES * sm_mhz * 1e6 / 1e12:.3f} Tops/s; memory "
          f"{MEM_BYTES_PER_S / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({os.path.relpath(_build.library_path(), ROOT)})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return sm_mhz


def edge_pairs(rng, n: int):
    """n seeded 1-2 kb pairs at ~5 % edits, plus empty, N and out-of-band
    rows."""
    pairs = []
    for _ in range(n - 6):
        a = rng.integers(0, 4, int(rng.integers(1000, 2001)))
        pairs.append((to_str(a), to_str(mutate(a, round(0.05 * len(a)), rng))))
    a = to_str(rng.integers(0, 4, 1500))
    n_rich = a[:700] + "N" * 20 + a[720:]
    pairs += [("", a[:40]), (a[:40], ""), ("", ""), (n_rich, n_rich),
              (a, a[:1000]), (a[:1200], a[:1180])]
    return pairs


def phase_kernels(rng):
    """Phases 2 and 3: each kernel against its plain version on the card.
    Returns the largest absolute differences seen."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, tb_decode
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    pairs = edge_pairs(rng, 256)
    q, qlen, t, tlen = from_reference(*pack(pairs), device="cuda")[:4]
    qlen_np, tlen_np = qlen.cpu().numpy(), tlen.cpu().numpy()
    err_nw = err_tb = 0
    for r in (3, 16, 64, 200):
        s_k, tb_k = nw_diag.banded_nw_diag(q, qlen, t, tlen, r)
        torch.cuda.synchronize()
        s_p, tb_p = nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, r)
        d_s = int((s_k.long() - s_p.long()).abs().max())
        d_tb = int((tb_k.int() - tb_p.int()).abs().max())
        err_nw = max(err_nw, d_s, d_tb)
        ok = (s_k < nw_diag.INF).cpu().numpy()
        p_k = nw_diag.traceback_paths_diag(tb_k.cpu().numpy(), qlen_np,
                                           tlen_np, r)
        p_p = nw_diag.traceback_paths_diag(tb_p.cpu().numpy(), qlen_np,
                                           tlen_np, r)
        bad = [b for b in np.flatnonzero(ok) if p_k[b] != p_p[b]]
        print(f"phase 2 nw_diag r={r}: B={len(pairs)} Lq={q.shape[1]} "
              f"Lt={t.shape[1]} finite={int(ok.sum())} score_diff={d_s} "
              f"tb_diff={d_tb} path_mismatches={len(bad)}")
        check(d_s == 0 and d_tb == 0 and not bad,
              f"nw_diag kernel disagrees with its plain version at r={r}")
        check(not ok[-2], "the out-of-band row must score INF")

        pk, sk = tb_decode.decode_diag(tb_k, qlen, tlen, r)
        torch.cuda.synchronize()
        pp, sp = tb_decode.decode_diag_torch(tb_k, qlen, tlen, r)
        okt = torch.from_numpy(ok).cuda()
        d_p = int((pk[okt].long() - pp[okt].long()).abs().max())
        d_st = int((sk[okt].long() - sp[okt].long()).abs().max())
        err_tb = max(err_tb, d_p, d_st)
        paths = tb_decode.unpack_paths(pk.cpu().numpy(), sk.cpu().numpy())
        bad = [b for b in np.flatnonzero(ok) if paths[b] != p_p[b]]
        print(f"phase 3 tb_decode r={r}: packed_diff={d_p} start_diff={d_st} "
              f"path_mismatches_vs_host={len(bad)}")
        check(d_p == 0 and d_st == 0 and not bad,
              f"tb_decode kernel disagrees with its plain version at r={r}")
    return err_nw, err_tb


def phase_golden():
    from claragenomicsanalysis_tpu_torch import cli
    data = os.path.join(ROOT, "data")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["align", f"{data}/sample_queries.fasta",
                       f"{data}/sample_targets.fasta", "--band-radius", "64",
                       "--device", "cuda"])
    with open(os.path.join(data, "golden", "sample_align.txt")) as f:
        golden = f.read()
    same = rc == 0 and buf.getvalue() == golden
    print(f"phase 4 golden: align --device cuda vs data/golden/"
          f"sample_align.txt: {'identical' if same else 'DIFFERENT'} "
          f"({len(golden.splitlines())} lines)")
    check(same, "align output differs from data/golden/sample_align.txt")


def main_path_pairs(n: int, seed: int, lo: int = 2000, hi: int = 10000):
    """n pairs cut from a seeded 2 Mb random genome: queries uniform in
    lo-hi bases, each target the query with round(0.05 * len) random edits
    (~5 % divergence, like ONT overlap pairs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    pairs = []
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        s = int(rng.integers(0, len(genome) - L))
        qs = genome[s: s + L]
        pairs.append((to_str(qs), to_str(mutate(qs, round(0.05 * L), rng))))
    return pairs


def run_aligner(pairs, algorithm: str, device="cuda"):
    """Align ``pairs`` with a fresh aligner sized to them; -> (results,
    wall seconds of align_all + get_alignments, ended by a sync)."""
    import torch
    from claragenomicsanalysis_tpu_torch import create_aligner
    aligner = create_aligner(max(len(a) for a, _ in pairs),
                             max(len(b) for _, b in pairs), len(pairs),
                             band_radius=64, algorithm=algorithm,
                             device=device)
    for a, b in pairs:
        aligner.add_alignment(a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aligner.align_all()
    results = aligner.get_alignments()
    torch.cuda.synchronize()
    return aligner, results, time.perf_counter() - t0


def phase_main(pairs, sm_mhz: float):
    """Phase 5, the ``ukkonen`` main path."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch import create_aligner
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, tb_decode
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    from claragenomicsanalysis_tpu_torch.utils.profiling import kernel_times

    n = len(pairs)
    max_q = max(len(a) for a, _ in pairs)
    max_t = max(len(b) for _, b in pairs)
    aligner = create_aligner(max_q, max_t, n, band_radius=64, device="cuda")
    for a, b in pairs:
        aligner.add_alignment(a, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with kernel_times() as kt:
        aligner.align_all()
        results = aligner.get_alignments()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    plan = aligner._plan(np.array([len(a) for a, _ in pairs]),
                         np.array([len(b) for _, b in pairs]))
    radius = np.zeros(n, np.int64)
    for r, sel in plan:
        radius[sel] = r
    bases = sum(len(a) + len(b) for a, b in pairs)
    print(f"phase 5 main path (ukkonen): {n} alignments in {wall:.3f} s = "
          f"{n / wall:.1f} alignments/s = {bases / wall / 1e6:.2f} Mbp/s "
          f"(query + target) end to end; launches={launches} "
          f"chunks={len(plan)} radii={sorted(set(radius.tolist()))} "
          f"max_memory_allocated={peak} B")
    check(launches == {"nw_diag": len(plan), "tb_decode": len(plan),
                       "myers": 0},
          f"launches {launches} != one of B1 and B2 per chunk "
          f"({len(plan)} chunks)")
    check(kt.count() == {"nw_diag": len(plan), "tb_decode": len(plan)},
          f"timed launches {kt.count()}")
    dev_ms = kt.ms()
    busy = sum(dev_ms.values())
    print(f"phase 5 breakdown (CUDA events inside the run): nw_diag "
          f"{dev_ms['nw_diag']:.2f} ms + tb_decode {dev_ms['tb_decode']:.2f} "
          f"ms = {busy:.2f} ms of {wall * 1e3:.1f} ms end to end "
          f"(kernel share {busy / (wall * 1e3):.4f})")
    check_paths(results, pairs, "ukkonen")
    dists = np.array([r.edit_distance for r in results])
    lens = np.array([len(a) for a, _ in pairs])
    print(f"phase 5 checks: {len(results)}/{n} SUCCESS paths consume both "
          f"sequences and cost their distance; distance/len mean "
          f"{float((dists / lens).mean()):.4f}")

    # 16 sampled pairs through the plain versions on the card
    rng = np.random.default_rng(SEED + 1)
    groups = {}
    for b in sorted(rng.choice(n, 16, replace=False).tolist()):
        groups.setdefault(int(radius[b]), []).append(b)
    for r, idxs in groups.items():
        q, qlen, t, tlen = from_reference(*pack([pairs[b] for b in idxs]),
                                          device="cuda")[:4]
        s, tb = nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, r)
        packed, start = tb_decode.decode_diag_torch(tb, qlen, tlen, r)
        paths = tb_decode.unpack_paths(packed.cpu().numpy(),
                                       start.cpu().numpy())
        for k, b in enumerate(idxs):
            check(paths[k] == results[b].path
                  and int(s[k]) == results[b].edit_distance,
                  f"pair {b}: main path differs from the plain version")
    print(f"phase 5 plain: 16 sampled pairs ({len(groups)} radii) equal the "
          f"plain-PyTorch path and distance on the card")

    # each kernel against its plain version, outputs, times and bounds, at
    # the largest bucket's first chunk
    sizes = {}
    for r, sel in plan:
        sizes[r] = sizes.get(r, 0) + len(sel)
    r, sel = next(c for c in plan if c[0] == max(sizes, key=sizes.get))
    arrays = pack([pairs[b] for b in sel], aligner.config.padded_query_length,
                  aligner.config.padded_target_length)
    q, qlen, t, tlen = from_reference(*arrays, device="cuda")[:4]
    per = time_banded(q, qlen, t, tlen, r, sm_mhz, "phase 5")
    for k, n_launch in launches.items():
        per.setdefault(k, {}).update(launches=n_launch,
                                     run_ms=dev_ms.get(k, 0.0))
    return {"results": results, "radius": radius, "kernels": per}


def time_banded(q, qlen, t, tlen, r: int, sm_mhz: float, tag: str) -> dict:
    """B1 and B2 against their plain versions on these inputs, exactly
    (B1: scores and the whole tb; B2: packed paths and starts, on B1's tb),
    with times (kernel: mean of 5 launches; plain: one call) and bounds:
    for B1 7 int32 operations per band cell, q, t and the lengths read once,
    scores and tb written once; for B2 16 operations per step of the walk,
    one tb byte read per step, the packed paths and starts written once."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, tb_decode
    ms_nw, (s_k, tb_k) = cuda_ms(
        lambda: nw_diag.banded_nw_diag(q, qlen, t, tlen, r), 5)
    ms_nw_plain, (s_p, tb_p) = cuda_ms(
        lambda: nw_diag.banded_nw_diag_torch(q, qlen, t, tlen, r), 1)
    ms_tb, (pk_k, st_k) = cuda_ms(
        lambda: tb_decode.decode_diag(tb_k, qlen, tlen, r), 5)
    ms_tb_plain, (pk_p, st_p) = cuda_ms(
        lambda: tb_decode.decode_diag_torch(tb_k, qlen, tlen, r), 1)
    err_nw = max(int((s_k.long() - s_p.long()).abs().max()),
                 int((tb_k.int() - tb_p.int()).abs().max()))
    err_tb = max(int((pk_k.long() - pk_p.long()).abs().max()),
                 int((st_k.long() - st_p.long()).abs().max()))
    B = q.shape[0]
    shape = (f"B={B} Lq={q.shape[1]} Lt={t.shape[1]} r={r} "
             f"W={nw_diag.band_slots(r)} tb={tuple(tb_k.shape)}")
    print(f"{tag} kernels ({shape}): nw_diag kernel {ms_nw:.3f} ms vs "
          f"plain {ms_nw_plain:.1f} ms, scores+tb max diff {err_nw}; "
          f"tb_decode kernel {ms_tb:.3f} ms vs plain {ms_tb_plain:.1f} ms, "
          f"packed+start max diff {err_tb}")
    check(err_nw == 0 and err_tb == 0,
          f"a banded kernel disagrees with its plain version ({tag}, "
          f"{shape})")

    ql = qlen.cpu().numpy().astype(np.int64)
    tl = tlen.cpu().numpy().astype(np.int64)
    i = np.arange(int(ql.max(initial=0)) + 1)[None, :]
    lo = np.maximum(0, i - r)
    hi = np.minimum(tl[:, None], i + r)
    cells = int(np.where(i <= ql[:, None], np.maximum(0, hi - lo + 1),
                         0).sum())
    io_bytes = q.nbytes + t.nbytes + 8 * B
    b_nw = bound(OPS_PER_BAND_CELL * cells, io_bytes + 4 * B + tb_k.numel(),
                 sm_mhz)
    steps = int((ql + tl).sum())
    b_tb = bound(OPS_PER_WALK_STEP * steps,
                 steps + 8 * B + 4 * pk_k.numel() + 4 * B, sm_mhz)
    print(f"{tag} bounds: nw_diag {cells} band cells x {OPS_PER_BAND_CELL} "
          f"ops, {io_bytes + tb_k.numel()} B -> {b_nw[0]:.4f} ms "
          f"({b_nw[1]}); tb_decode {steps} steps x {OPS_PER_WALK_STEP} ops "
          f"-> {b_tb[0]:.4f} ms ({b_tb[1]})")
    return {"nw_diag": {"shape": shape, "ms": ms_nw, "plain_ms": ms_nw_plain,
                        "bound": b_nw, "err": err_nw},
            "tb_decode": {"shape": shape, "ms": ms_tb,
                          "plain_ms": ms_tb_plain, "bound": b_tb,
                          "err": err_tb}}


def myers_edge_pairs(rng):
    """Query lengths at the 32-base word boundaries, 1-2 kb pairs at ~5 %
    edits, empty sides, N-rich pairs and a long length difference."""
    pairs = []
    for n in (31, 32, 33, 64, 65):
        a = rng.integers(0, 4, n)
        pairs.append((to_str(a), to_str(mutate(a, 3, rng))))
    for _ in range(24):
        a = rng.integers(0, 4, int(rng.integers(1000, 2001)))
        pairs.append((to_str(a), to_str(mutate(a, round(0.05 * len(a)), rng))))
    a = to_str(rng.integers(0, 4, 1500))
    n_rich = a[:700] + "N" * 20 + a[720:]
    pairs += [("", a[:40]), (a[:40], ""), ("", ""), (n_rich, n_rich),
              ("N" * 50, a[:50]), (a, a[:1000])]
    return pairs


def phase_myers_edges(rng) -> int:
    """Phase 6: the Myers kernel against its plain version, whole rows and
    scores, on the edge batch and at the longest query it takes (4,096
    words: 1,024 threads and more than the default 48 KB of shared
    memory)."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import myers
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    pairs = myers_edge_pairs(rng)
    a = rng.integers(0, 4, myers.MAX_WORDS * myers.WORD)
    longest = [(to_str(a), to_str(mutate(a[:2000], 100, rng)))]
    err = 0
    for name, batch in (("edge batch", pairs), ("longest query", longest)):
        q, qlen, t, tlen = from_reference(*pack(batch), device="cuda")[:4]
        rows_k, s_k = myers.myers_bottom_row(q, qlen, t, tlen)
        torch.cuda.synchronize()
        rows_p, s_p = myers.myers_bottom_row_torch(q, qlen, t, tlen)
        d = max(int((rows_k.long() - rows_p.long()).abs().max()),
                int((s_k.long() - s_p.long()).abs().max()))
        err = max(err, d)
        print(f"phase 6 myers {name}: B={len(batch)} Lq={q.shape[1]} "
              f"Lt={t.shape[1]} rows+scores max diff {d}")
        check(d == 0, f"myers kernel disagrees with its plain version on "
              f"the {name}")
        if name == "edge batch":
            k = len(pairs) - 6
            print(f"phase 6 scores of the empty / N rows {s_k[k:].tolist()}")
            check(s_k[k:k + 3].tolist() == [40, 40, 0]
                  and s_k[k + 4].item() == 50,
                  "empty-side and N scores wrong")
            check(torch.equal(rows_k[k].cpu(),
                              torch.arange(t.shape[1] + 1,
                                           dtype=torch.int32)),
                  "an empty query's bottom row must count the columns")
    return err


def time_myers(q, qlen, t, tlen, sm_mhz: float) -> dict:
    """The Myers kernel against its plain version on these inputs: exact
    difference, times (kernel: mean of 5 launches; plain: one call) and the
    bound (27 int32 operations per needed query word and column; q, t and
    the lengths read once, rows and scores written once)."""
    from claragenomicsanalysis_tpu_torch.ops import myers
    ms_k, (rows_k, s_k) = cuda_ms(
        lambda: myers.myers_bottom_row(q, qlen, t, tlen), 5)
    ms_p, (rows_p, s_p) = cuda_ms(
        lambda: myers.myers_bottom_row_torch(q, qlen, t, tlen), 1)
    err = max(int((rows_k.long() - rows_p.long()).abs().max()),
              int((s_k.long() - s_p.long()).abs().max()))
    B, Lt = q.shape[0], t.shape[1]
    words = int(((qlen.long() + 31) // 32).sum())
    nbytes = q.nbytes + t.nbytes + 8 * B + 4 * rows_k.numel() + 4 * B
    return {"ms": ms_k, "plain_ms": ms_p, "err": err, "words": words,
            "Lt": Lt, "cells": 32 * words * Lt, "scores": s_k.cpu().numpy(),
            "bound": bound(OPS_PER_MYERS_WORD * words * Lt, nbytes, sm_mhz),
            "shape": f"B={B} Lq={q.shape[1]} Lt={Lt} "
                     f"Wq={-(-q.shape[1] // 32)}"}


def phase_myers_main(pairs, ukk, sm_mhz: float):
    """Phase 7, the ``myers`` main path on phase 5's pairs.

    Its distances are exact, phase 5's are the band's optimum, so every
    myers distance is <= the ukkonen one, and equal where the ukkonen score
    fits its radius.  On these 2-10 kb pairs at 5 % no ukkonen score fits
    (the radii are 64-128), so that check holds vacuously here and phase 8
    carries it, on a non-empty set.  Yet the edits of this seeded data are
    spread evenly, so every pair has an optimal path inside its ukkonen
    band: the two distances are equal on every pair, and the phase holds
    them to that."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch import create_aligner
    from claragenomicsanalysis_tpu_torch.align.hirschberg import BASE_Q
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    from claragenomicsanalysis_tpu_torch.utils.profiling import kernel_times

    n = len(pairs)
    aligner = create_aligner(max(len(a) for a, _ in pairs),
                             max(len(b) for _, b in pairs), n,
                             band_radius=64, algorithm="myers",
                             device="cuda")
    for a, b in pairs:
        aligner.add_alignment(a, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    zero_hirschberg()
    t0 = time.perf_counter()
    with kernel_times() as kt:
        aligner.align_all()
        results = aligner.get_alignments()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_hirsch, levels = read_hirschberg()
    peak = torch.cuda.max_memory_allocated()
    bases = sum(len(a) + len(b) for a, b in pairs)
    print(f"phase 7 main path (myers): {n} alignments in {wall:.3f} s = "
          f"{n / wall:.1f} alignments/s = {bases / wall / 1e6:.2f} Mbp/s "
          f"(query + target) end to end; launches={launches}; routes: "
          f"{n_hirsch} Hirschberg, {n - n_hirsch} banded (padded Lq="
          f"{aligner.config.padded_query_length}); Hirschberg levels="
          f"{levels}; max_memory_allocated={peak} B")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the myers path never launched: {launches}")
    check(n_hirsch == n and launches["myers"] == 1 + levels,
          "at a padded query length over 2,048 every pair must go to "
          "Hirschberg, with one Myers launch per level after the score pass")
    check(kt.count() == launches, f"timed launches {kt.count()}")
    dev_ms = kt.ms()
    busy = sum(dev_ms.values())
    per_myers = [s.elapsed_time(e) for s, e in kt.events["myers"]]
    print(f"phase 7 breakdown (CUDA events inside the run): " + " + ".join(
        f"{k} {v:.2f} ms" for k, v in dev_ms.items())
        + f" = {busy:.2f} ms of {wall * 1e3:.1f} ms end to end (kernel "
        f"share {busy / (wall * 1e3):.4f}); myers launches "
        f"{[round(x, 3) for x in per_myers]} ms")

    # the banded kernels at the inputs of the path's largest B1 launch: a
    # Hirschberg base case, many short fragments at one radius
    q, qlen, t, tlen, r = kt.largest["nw_diag"]
    check(q.shape[1] <= BASE_Q, "the largest B1 launch is not a base case")
    per = time_banded(q, qlen, t, tlen, r, sm_mhz,
                      "phase 7 Hirschberg base case:")

    # the Myers kernel at the score pass and at the path's largest launch
    # (by work: Hirschberg's level 0, every pair's two halves)
    cfg = aligner.config
    score_pass = from_reference(*pack(pairs, cfg.padded_query_length,
                                      cfg.padded_target_length),
                                device="cuda")[:4]
    biggest = kt.largest["myers"]
    name = ("Hirschberg level 0" if biggest[0].shape[0] == 2 * n
            else "largest launch")
    calls = {"score pass": time_myers(*score_pass, sm_mhz),
             name: time_myers(*biggest, sm_mhz)}
    for name, c in calls.items():
        print(f"phase 7 myers kernel at the {name} ({c['shape']}): kernel "
              f"{c['ms']:.3f} ms vs plain {c['plain_ms']:.1f} ms, rows+scores "
              f"max diff {c['err']}; bound {c['words']} words x {c['Lt']} "
              f"columns x {OPS_PER_MYERS_WORD} ops -> {c['bound'][0]:.4f} ms "
              f"({c['bound'][1]}); {c['cells'] / (c['ms'] * 1e-3) / 1e12:.3f}"
              f" Tcells/s")
        check(c["err"] == 0, f"myers kernel disagrees with its plain version "
              f"at the {name}")
    largest = max(calls, key=lambda k: calls[k]["cells"])
    print(f"phase 7 largest Myers call by work: the {largest}")
    per["myers"] = dict(calls[largest], err=max(c["err"]
                                                for c in calls.values()))
    for k, n_launch in launches.items():
        per[k].update(launches=n_launch, run_ms=dev_ms.get(k, 0.0))

    check_paths(results, pairs, "myers")
    dists = np.array([r.edit_distance for r in results])
    check(np.array_equal(dists, calls["score pass"]["scores"]),
          "myers distances differ from the kernel's scores")
    u_dist = np.array([r.edit_distance for r in ukk["results"]])
    exact = u_dist <= ukk["radius"]
    n_equal = int((dists == u_dist).sum())
    check(bool((dists <= u_dist).all()), "a myers distance exceeds ukkonen's")
    check(np.array_equal(dists[exact], u_dist[exact]),
          "myers differs from ukkonen where ukkonen's band held the score")
    print(f"phase 7 checks: {n}/{n} SUCCESS paths consume both sequences, "
          f"cost their distance, distance == the kernel's score; <= the "
          f"ukkonen distance everywhere, equal on the {int(exact.sum())} "
          f"pairs whose ukkonen score <= its radius; equal on {n_equal}, "
          f"strictly lower on {int((dists < u_dist).sum())}")
    check(n_equal == n, f"myers distances equal ukkonen's on {n_equal} of "
          f"{n} pairs, not all")

    sub = pairs[:N_SUBSET]
    for algorithm in ("hirschberg-myers", "banded-escalate"):
        zero_hirschberg()
        _, res, w = run_aligner(sub, algorithm)
        same = all((r.path, r.edit_distance) == (m.path, m.edit_distance)
                   for r, m in zip(res, results))
        print(f"phase 7 {algorithm} on {len(sub)} of these pairs: "
              f"{w:.3f} s, routed to Hirschberg {read_hirschberg()[0]}, "
              f"paths and distances equal myers': {same}")
        check(same, f"{algorithm} differs from myers on the subset")
    return per


def phase_short_reads():
    """Phase 8: 0.5-1 kb pairs, where the rule keeps pairs banded."""
    import numpy as np
    pairs = main_path_pairs(N_SHORT, SEED + 2, 500, 1000)
    out = {}
    for algorithm in ("ukkonen", "myers", "banded-escalate"):
        zero_hirschberg()
        aligner, res, w = run_aligner(pairs, algorithm)
        routed = read_hirschberg()[0]
        check_paths(res, pairs, algorithm)
        out[algorithm] = res
        print(f"phase 8 short reads ({algorithm}): {len(pairs)} pairs of "
              f"0.5-1 kb in {w:.3f} s = {len(pairs) / w:.1f} alignments/s; "
              f"routes: {len(pairs) - routed} banded, {routed} "
              f"Hirschberg (padded Lq={aligner.config.padded_query_length})")
    same = all((a.path, a.edit_distance) == (b.path, b.edit_distance)
               for a, b in zip(out["myers"], out["banded-escalate"]))
    # where ukkonen's score fits its radius, its banded path is the dense
    # canonical one, which the myers re-run must reproduce
    plan = aligner._plan(np.array([len(a) for a, _ in pairs]),
                         np.array([len(b) for _, b in pairs]))
    radius = {int(b): r for r, sel in plan for b in sel}
    held = [b for b, u in enumerate(out["ukkonen"])
            if u.edit_distance <= radius[b]]
    canon = all((out["myers"][b].path, out["myers"][b].edit_distance)
                == (out["ukkonen"][b].path, out["ukkonen"][b].edit_distance)
                for b in held)
    print(f"phase 8 myers == banded-escalate (paths and distances): {same}; "
          f"myers == ukkonen on the {len(held)} pairs whose ukkonen score "
          f"<= its radius: {canon}")
    check(same, "myers and banded-escalate differ on short reads")
    check(canon and len(held) > 0,
          "myers differs from ukkonen's canonical paths on short reads")


def phase_cli_algorithms():
    """Phase 9: cli align on the card and on the CPU, byte for byte."""
    from claragenomicsanalysis_tpu_torch import cli
    data = os.path.join(ROOT, "data")
    for algorithm in ("myers", "hirschberg-myers"):
        outs = []
        for device in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["align", f"{data}/sample_queries.fasta",
                               f"{data}/sample_targets.fasta", "--algorithm",
                               algorithm, "--print-alignments", "--device",
                               device])
            check(rc == 0, f"cli align --algorithm {algorithm} failed")
            outs.append(buf.getvalue())
        same = outs[0] == outs[1]
        print(f"phase 9 cli align --algorithm {algorithm}: --device cuda vs "
              f"--device cpu {'identical' if same else 'DIFFERENT'} "
              f"({len(outs[0].splitlines())} lines)")
        check(same, f"cli align --algorithm {algorithm} differs between "
              f"cuda and cpu")


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    sm_mhz = phase_env()
    err_nw, err_tb = phase_kernels(np.random.default_rng(SEED))
    phase_golden()
    t0 = time.perf_counter()
    pairs = main_path_pairs(N_PAIRS, SEED)
    print(f"phase 5 data: {N_PAIRS} pairs, query 2-10 kb, max_q="
          f"{max(len(a) for a, _ in pairs)} max_t="
          f"{max(len(b) for _, b in pairs)}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    ukk = phase_main(pairs, sm_mhz)
    err_my = phase_myers_edges(np.random.default_rng(SEED + 3))
    paths = {"ukkonen": ukk["kernels"],
             "myers": phase_myers_main(pairs, ukk, sm_mhz)}
    phase_short_reads()
    phase_cli_algorithms()

    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "claragenomicsanalysis_tpu")
                    or m.startswith(("jax.", "claragenomicsanalysis_tpu.")))
    check(not loaded, f"the port loaded the JAX package or jax: {loaded}")

    errs = {"nw_diag": err_nw, "tb_decode": err_tb, "myers": err_my}
    meta = {
        "nw_diag": ("claragenomicsanalysis_tpu_torch/csrc/nw_diag.cu",
                    "claragenomicsanalysis_tpu/ops/nw_diag_pallas.py:93"),
        "tb_decode": ("claragenomicsanalysis_tpu_torch/csrc/tb_decode.cu",
                      "claragenomicsanalysis_tpu/ops/tb_decode_pallas.py:33"),
        "myers": ("claragenomicsanalysis_tpu_torch/csrc/myers.cu",
                  "claragenomicsanalysis_tpu/ops/myers_pallas.py:39"),
    }
    kernels = []
    for k, (src, rep) in meta.items():
        runs = {p: v[k] for p, v in paths.items()}
        timed = {p: v for p, v in runs.items() if "ms" in v}
        top = max(timed.values(), key=lambda v: v["run_ms"])
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(v["launches"] for v in runs.values()),
            "max_abs_err": max([errs[k]] + [v["err"] for v in timed.values()]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound"][0], "bound_by": top["bound"][1],
            "library_ms": None,
            "paths": {p: {"launches": v["launches"],
                          "run_ms": v["run_ms"]} | (
                {"shape": v["shape"], "ms": v["ms"],
                 "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                 "bound_by": v["bound"][1]} if p in timed else {})
                for p, v in runs.items()}})
    print(f"total: {time.perf_counter() - t_start:.1f} s of command time; "
          f"no module of claragenomicsanalysis_tpu and no jax loaded")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
