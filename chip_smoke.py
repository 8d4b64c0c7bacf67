#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (claragenomicsanalysis_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one line or more each:
  1. environment, the card's name, power limit and SM clock, and the kernel
     build (nvcc, from csrc/ in this checkout);
  2. the banded-NW kernels against their plain PyTorch versions on the card:
     the anti-diagonal one (B1) in each of its plans (a warp a problem at
     K = 1-8 slots a lane, q and t staged or read through L1; a block a
     problem, shared or device: NW_DIAG_PLANS), each timed with its bound,
     and the row one (B3) in each of its plans (a warp a problem at K = 1-8
     band lanes a lane, q and t staged or read through L1, r = 127 the
     widest; a block a problem from r = 128, shared or device:
     NW_ROW_PLANS; and two bands wider than a block's 1,024 threads), each
     row result also against B1's scores and paths;
  3. the traceback-decode kernels (B2, both layouts) against their plain
     versions on the same tb, and at their plan's row threshold (60 and 64
     packed rows); every B2 launch this script replays (phases 2, 3, 5, 7,
     16 and 17) also runs in the plan its shape does not take (a warp a
     problem staging its rows in shared memory, or a thread a problem);
  4. the port's ``align`` CLI on the bundled data against the golden file,
     through ``create_aligner(..., kernel="diag")`` and ``kernel="row"``;
  5. the ``ukkonen`` main path, ``create_aligner(..., device="cuda")`` then
     ``align_all``, on 1,024 pairs of 2-10 kb at about 5 % divergence, with
     its checks, launch counts and the kernels' CUDA-event times inside the
     run; then each kernel against its plain version, outputs, times and
     bounds, at the path's largest chunk;
  6. the Myers kernel against its plain version on an edge batch, on
     batches whose query reaches each lane count (G = 1..32 lanes a
     problem) and one to three passes, and (C9) at 4,097 query words
     (131,104 bases, 9 passes) against a 2 kb target, timed with its
     bound; then the ``myers`` algorithm on that pair, a SUCCESS path at
     the plain version's score;
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
     CPU, byte for byte;
 10. the lockstep POA kernels (B7 topsort, B5 graph NW + traceback, B6 add
     with the MSA's paths, B8 consensus, B9 MSA) against their plain
     versions at every launch of a run under tight caps (node, clique and
     edge overflows), full and banded, with an empty window, an empty first
     sequence, N bases, a first sequence over the node cap and a 2-node
     graph against 60 bases (banded: sums on NEG); then the
     one-kernel-per-window POA (B10) on the same windows against the
     lockstep loop over the plain versions, with and without the MSA, in
     each of its plans (a warp or a block a window, rings of 8, 2 and 0
     rows) and on 8-byte plane words; then B6's edges (clique capacities
     A = 1, 31, 32 and 63 filled, the edge and node overflows), every
     lockstep launch against the plain versions; then B7's edges: every
     topsort launch of a lockstep run with its hint, with hints wrong on
     purpose and on a window given a cycle, in each of its plans; then B8
     and B9 in each of their plans (4, 2 or 1 windows a block, B9's
     columns alone in shared memory, the tables in device scratch) on the
     consensus and MSA calls of two lockstep runs, B8 also on a window
     given a cycle and on a rank that is no permutation;
 10b. B5's variants (a warp or a block a window, with the ring, a 2-row
     ring and none; 72 pred slots; 8-byte plane words) against its plain
     version at every lockstep launch;
 11. ``cli poa`` on the card against the consensus golden, ``--msa`` against
     the MSA golden and the CPU, and ``--banded`` on the card and the CPU,
     byte for byte;
 12. the ``poa`` main path, ``create_batch(..., device="cuda")`` then
     ``get_consensus``, at the read-correction polish's window shape: 4,096
     windows of 8 copies of a 128-base backbone with 6 edits each; its
     rates, checks (all SUCCESS, the CPU plain path on 64 windows, the
     consensus closer to the backbone than a support), launch counts and
     each kernel against its plain version at its largest launch, with
     times and bounds;
 13. the same for 512 deep windows (16 copies of a 256-base backbone, 12
     edits each, N = 1,024, 16 pred slots), banded;
 14. the MSA main path, ``create_batch(..., output_mask=CONSENSUS | MSA,
     device="cuda")`` then ``get_consensus`` and ``get_msa``, on 4,096
     windows of 8 copies of a 100-base backbone with 5 edits each (N = 256,
     4 pred slots): the same checks, the rows of every window (one length,
     each row its sequence unless a shared column took bases of it), and
     ``get_graphs`` on 64 windows against the final graph state;
 15. the one-kernel-per-window route (``kernel="window"``) on phase 14's
     windows with the MSA, phase 12's and phase 13's (deep, banded) without:
     outputs equal to the lockstep route's, its wall beside the lockstep
     route's on the same data, B10 against its plain version at its
     largest launch in its plan and in the other one (a warp or a block a
     window), with times and bound;
 16. the row route, ``create_aligner(..., kernel="row")``, on phase 5's
     1,024 pairs (``ukkonen``): results equal to phase 5's pair for pair,
     B3 and B2's row decode launched and B1 and B2's diag decode not, its
     wall beside phase 5's, each kernel against its plain version at its
     largest launch with times and bounds; then ``myers``,
     ``hirschberg-myers`` and ``banded-escalate`` through it on phase 7's
     subset, equal to the diag route;
 17. C8, the aligner: a pair whose lengths differ by 16,385 through all four
     algorithms and both banded kernels (B1's and B3's device-memory
     variants, B3 at W = 65,672, a Hirschberg base case against a 16,385
     base target side), SUCCESS paths at one distance, diag == row,
     ``hirschberg-myers`` equal to the plain versions, each device variant
     against its plain version with times and bounds;
 18. C8, POA: windows at ``cli poa``'s sizes of 2,048-base sequences with
     the MSA (every launch against the plain versions; B8 one window a
     block, B5 a block a window) and of 9,000-base sequences (B7 and B8 on
     device memory, B5 past L = 8,191), each kernel at its largest launch
     against its plain version with times and bounds; then C10, B9
     launched directly at N = 58,120 (cli poa's sizing for 19,371-base
     sequences, its tables in device memory) against its plain version;
 19. the mapper (torch ops, no kernel): ``cli map --device cuda`` against
     both map goldens, byte for byte; then 10 Mbp of simulated reads (1,000
     x 10 kb, a 3 MB index budget: 16 chunk pairs) through
     ``map_all_vs_all`` on the card and on the CPU, rows equal, checked
     against the reads' placements;
 20. the map main path at full size, ``scripts/bench_map_scale.py``'s
     default shape: 10,000 reads of median 10 kb (100 Mbp, 20x of a 5 Mbp
     genome) through ``map_all_vs_all(..., device="cuda")`` at
     ``MapperConfig()``'s defaults (16 chunk pairs), one warm-up and one
     timed run: Mbp/s, overlaps/s, statuses, anchors, peak device memory,
     each ``mapper.*`` stage's CUDA-event and host time, the host share,
     and the two largest host parts re-run alone (the reads' simulation is
     set-up, outside the wall);
 21. the overlap -> CIGAR pipeline: ``cli pipeline --device cuda`` against
     its golden, byte for byte; then its main path at full size,
     ``run_pipeline(..., device="cuda")`` on scripts/bench_correct_scale.py's
     default reads (1,000 x 5 kb at 5 %, 10x of a 500 kb genome; its
     mapper settings, PipelineConfig's defaults): CIGAR'd alignments/s and
     Mbp/s end to end, failures, each stage's CUDA-event and host time,
     the kernel share and peak device memory; every CIGAR against its
     spans, the rows without cg:Z against map_all_vs_all's, 64 spans
     through the CPU plain path, recall and precision by evaluate_paf;
 22. read correction: ``cli correct --device cuda`` (both POA routes)
     against its golden; then its main path, ``correct_reads(...,
     device="cuda")`` on phase 21's reads at bench_correct_scale.py's
     CorrectConfig: corrected bases/s, windows polished / total / failed,
     each stage's CUDA-event and host time and host share, the mean edit
     distance to each read's true span before and after (by the Myers
     kernel); then a run stopped after one part and resumed, on the reads
     of the genome's first 64 kb, equal to the uninterrupted run, and
     those reads at cli correct's max_support of 15, B5 held against its
     plain version at its deepest launch (16 pred slots, N = 384);
 23. the multi-rank paths (claragenomicsanalysis_tpu_torch/parallel/):
     two ranks on cuda:0 (gloo, explicit devices), or one a card (NCCL)
     where torch finds two, each its own process (multihost.run_ranks),
     each rank's launches counted in a ``stage_times()`` block around
     a path: (a) phase 20's map at full width on the 'rep' axis, rows
     equal to phase 20's, its wall, Mbp/s, each rank's stages, the
     all_to_all's bytes and ms and peak memory; (b) phase 22's correction
     on both views (map on 'rep', reads dealt on 'data'), corrected reads
     equal to phase 22's, corrected bases/s and each rank's kernel share;
     (c)
     ``ukkonen`` on 'data' on phase 5's pairs (equal to phase 5), phase
     12's windows on 'data' through both POA routes (equal to phase 12),
     and ``hirschberg-myers`` on the 'sp' ring with its levels of 4,096
     bases or more on the ring, on phase 7's 64-pair subset (paths equal
     to phase 7's), with the ring's ms a level; (d) ``cli align | poa |
     map | pipeline | correct -d 2 --device cuda``: byte-equal to the
     goldens on two cards, the JAX message on one.  After each path of
     (b) and (c) rank 0 replays each kernel it launched at its largest
     launch against its plain version, at the shapes its share gave it.
     ``python3 chip_smoke.py --multi-rank`` runs phases 1 and 23 alone,
     with their own one-rank references.
Then a line per redesigned kernel (B1-B10) with its time
at each main path's largest launch beside the first design's as PERF.md
records it (FIRST_DESIGN_MS, not measured by this run) and its bound, and a
line per variant of phases 2, 3, 6, 15, 17 and 18.  Then one JSON line
describing every kernel: under ``paths``, for each main path (``ukkonen``,
``myers``, ``poa``, ``poa_deep``, ``poa_msa``, ``poa_window``,
``poa_window_msa``, ``poa_window_deep``, ``ukkonen_row``, ``pipeline``,
``correct``, and phase 23's ``correct_2ranks``, ``ukkonen_data2``,
``poa_data2``, ``poa_window_data2`` and ``hirschberg_sp2``, launches and
run time summed over the ranks, the replay rank 0's), its launches in that run (the ``launch.*`` counters of a
``stage_times()`` block around it), the kernel's device time in that run (``run_ms``) and, at
that path's largest launch, the plan it took and the kernel's time, plain
time and bound (the least time the card could take for the same work; at
``pipeline`` and ``correct`` for the kernel that spent the most device
time there); under ``variants`` the
figures of phases 2, 3, 6, 15, 17 and 18 and of the B2 launches replayed in
the other plan (every number in the line measured by this run, but the
bounds, which it computes); at the top level the sum of the launches, the
largest difference from the plain version seen anywhere, and the times of
the path where the kernel spent the most device time.  Last ``{"ok": true,
"device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result; so does a machine with no
CUDA device.  The comparisons are exact: the DP is integer work.  The script
reaches only the port (``claragenomicsanalysis_tpu_torch``); its data is
made with NumPy from ``SEED``, and it checks at its end that no module of
``claragenomicsanalysis_tpu`` and no ``jax`` was loaded.
"""

import contextlib
import ctypes
import gc
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
OPS_PER_BAND_CELL = 7    # nw_diag, nw_row: compare, 2 adds, 2 mins, 2 code
                         # selects (one function: the same count for both)
OPS_PER_WALK_STEP = 16   # tb_decode(_row): address, extract, pack, i/j update
OPS_PER_MYERS_WORD = 27  # myers: one 32-bit word update (ops/myers_pallas.py)


#: the first designs' times at the main paths' largest launches as PERF.md
#: section 6 records them (chip_smoke.py on NVIDIA H100 80GB HBM3,
#: 700.00 W), printed beside the redesigned kernels' in the human-readable
#: lines only, labelled so: (kernel, path) -> ms
FIRST_DESIGN_MS = {("poa_nwtb", "poa"): 1.368, ("poa_nwtb", "poa_deep"): 2.042,
                   ("poa_nwtb", "poa_msa"): 1.191,
                   ("myers", "myers"): 9.327,
                   ("nw_diag", "ukkonen"): 4.816, ("nw_diag", "myers"): 1.864,
                   ("poa_window", "poa_window_msa"): 18.430,
                   ("poa_window", "poa_window"): 20.779,
                   ("tb_decode", "ukkonen"): 5.133, ("tb_decode", "myers"): 0.121,
                   ("tb_decode_row", "ukkonen_row"): 4.760,
                   ("poa_add", "poa"): 0.404, ("poa_add", "poa_deep"): 0.623,
                   ("poa_add", "poa_msa"): 0.310,
                   ("nw_row", "ukkonen_row"): 5.232,
                   ("poa_topsort", "poa"): 0.246,
                   ("poa_topsort", "poa_deep"): 0.400,
                   ("poa_topsort", "poa_msa"): 0.215,
                   ("poa_consensus", "poa"): 0.326,
                   ("poa_consensus", "poa_deep"): 0.439,
                   ("poa_consensus", "poa_msa"): 0.305,
                   ("poa_msa", "poa_msa"): 0.521}
FIRST_MYERS_MS = {"score pass": 7.023, "Hirschberg level 0": 9.327}


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


def settle_heap() -> None:
    """Called before a timed run: collect the cyclic garbage there is, then
    take every live object out of the collector's sight.  This script keeps
    its data and earlier results alive (millions of list elements), and a
    full collection that walks them takes 0.1-0.25 s; falling inside a timed
    run it was counted as the run's wall, and as device time of whichever
    kernel launch it interrupted.  What the run itself makes is still
    collected."""
    gc.collect()
    gc.freeze()


ALIGNER_KERNELS = ("nw_diag", "tb_decode", "nw_row", "tb_decode_row", "myers",
                   "cigar")
POA_KERNELS = ("poa_topsort", "poa_nwtb", "poa_add", "poa_consensus",
               "poa_msa", "poa_window")


def read_launches(st, names=ALIGNER_KERNELS) -> dict:
    """Launches of the kernels ``names`` in the ``stage_times()`` block
    ``st`` (``st.launches()``), 0 for one never launched."""
    launched = st.launches()
    return {name: launched.get(name, 0) for name in names}


def bound(ops: float, nbytes: float, sm_mhz: float) -> tuple[float, str]:
    """(ms, which binds): the larger of int32 operations over the card's
    int32 rate (132 SMs x 64 lanes x the SM clock) and bytes over its
    memory rate."""
    t_ops = ops / (SMS * INT32_LANES * sm_mhz * 1e6)
    t_bytes = nbytes / MEM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def read_hirschberg(st) -> tuple[int, int]:
    """(pairs aligned by Hirschberg, split levels run) in the
    ``stage_times()`` block ``st``."""
    return (st.counters.get("hirschberg.pairs", 0),
            st.counters.get("hirschberg.levels", 0))


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


def wide_band_pairs(rng, n: int):
    """n seeded pairs of 50-400 bases at ~30 % edits, the shape of the bands
    banded-escalate widens on short reads, plus empty and N rows."""
    pairs = []
    for _ in range(n - 3):
        a = rng.integers(0, 4, int(rng.integers(50, 401)))
        pairs.append((to_str(a), to_str(mutate(a, round(0.3 * len(a)), rng))))
    a = to_str(rng.integers(0, 4, 300))
    return pairs + [("", a), (a[:200], ""), (a[:100] + "N" * 20, a[:120])]


#: B1's plans reached in phase 2: (radius, SMEM_PER_BLOCK or None); the
#: lowered SMEM_PER_BLOCK moves a warp launch to reading q and t through L1
#: and a block launch to device memory, at these small shapes
NW_DIAG_PLANS = ((3, None), (40, None), (64, None), (100, None), (150, None),
                 (200, None), (255, None), (300, None), (64, 600),
                 (300, 600))


@contextlib.contextmanager
def smem_forced(limit):
    """Inside the block the kernels' plans see a block's shared memory as
    ``limit`` bytes (ops._build.SMEM_PER_BLOCK; None leaves it)."""
    from claragenomicsanalysis_tpu_torch.ops import _build
    saved = _build.SMEM_PER_BLOCK
    if limit is not None:
        _build.SMEM_PER_BLOCK = limit
    try:
        yield
    finally:
        _build.SMEM_PER_BLOCK = saved


@contextlib.contextmanager
def decode_forced(variant: str | None):
    """Inside the block ops.tb_decode.tb_decode_plan gives every shape the
    ``variant`` asked for: "thread" (STAGE_MIN_ROWS past any problem) or
    "staged" (no row or width threshold, a ring of up to a block's shared
    memory, so that even a one-row chunk of the widest band fits); None
    leaves it."""
    from claragenomicsanalysis_tpu_torch.ops import _build, tb_decode
    names = ("STAGE_MIN_ROWS", "STAGE_MAX_WIDTH", "RING_BYTES")
    saved = [getattr(tb_decode, k) for k in names]
    if variant == "thread":
        tb_decode.STAGE_MIN_ROWS = 1 << 30
    elif variant == "staged":
        tb_decode.STAGE_MIN_ROWS, tb_decode.STAGE_MAX_WIDTH = 0, 1 << 30
        tb_decode.RING_BYTES = _build.SMEM_PER_BLOCK
    try:
        yield
    finally:
        for k, v in zip(names, saved):
            setattr(tb_decode, k, v)


#: B2 launches replayed in the plan their shape does not take (time_banded,
#: phase 3's thresholds): kernel name -> variant figures
FORCED_PLANS = {"tb_decode": [], "tb_decode_row": []}


def phase_kernels(rng, sm_mhz: float):
    """Phases 2 and 3: each kernel against its plain version on the card,
    B1 in each of its plans (NW_DIAG_PLANS: a warp a problem at K = 1, 2, 3,
    4, 5, 7 and 8 slots a lane, staged or reading through L1; a block a
    problem, shared or device) with B2's decode of its traceback.  Returns the
    largest absolute differences seen, by kernel, and B1's plans' timed
    entries."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, tb_decode
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    pairs = edge_pairs(rng, 256)
    q, qlen, t, tlen = from_reference(*pack(pairs), device="cuda")[:4]
    qlen_np, tlen_np = qlen.cpu().numpy(), tlen.cpu().numpy()
    Lq, Lt = q.shape[1], t.shape[1]
    err_nw = err_tb = 0
    plans, cache = [], {}
    for r, limit in NW_DIAG_PLANS:
        with smem_forced(limit):
            plan = nw_diag.nw_diag_plan(Lq, Lt, r)
            keep = cache.setdefault(r, {})
            timed = time_banded(q, qlen, t, tlen, r, sm_mhz,
                                f"phase 2 ({'/'.join(map(str, plan))})",
                                plain=keep)
        err_nw = max(err_nw, timed["nw_diag"]["err"])
        err_tb = max(err_tb, timed["tb_decode"]["err"])
        s_k, tb_k, pk, sk = keep["kernel"]
        ok = (s_k < nw_diag.INF).cpu().numpy()
        p_k = nw_diag.traceback_paths_diag(tb_k.cpu().numpy(), qlen_np,
                                           tlen_np, r)
        if "host" not in keep:
            keep["host"] = nw_diag.traceback_paths_diag(
                keep["nw"][1][1].cpu().numpy(), qlen_np, tlen_np, r)
        p_p = keep["host"]
        bad = [b for b in np.flatnonzero(ok) if p_k[b] != p_p[b]]
        paths = tb_decode.unpack_paths(pk.cpu().numpy(), sk.cpu().numpy())
        bad_dec = [b for b in np.flatnonzero(ok) if paths[b] != p_p[b]]
        print(f"phase 2 nw_diag r={r} plan {plan}: B={len(pairs)} Lq={Lq} "
              f"Lt={Lt} finite={int(ok.sum())}, host paths of the kernel's "
              f"tb vs the plain version's: {len(bad)} mismatches; phase 3 "
              f"tb_decode's paths vs the host's: {len(bad_dec)} mismatches")
        check(not bad and not bad_dec,
              f"nw_diag or tb_decode disagrees with the plain version at "
              f"r={r} ({plan})")
        check(not ok[-2], "the out-of-band row must score INF")
        plans.append(timed["nw_diag"] | {
            "variant": f"{plan[0]} K={plan[1]} problems={plan[2]}"})
    errs = {"nw_diag": err_nw, "tb_decode": err_tb}
    errs |= phase_row_kernels(pairs, NW_ROW_PLANS)
    wide = phase_row_kernels(wide_band_pairs(rng, 64),
                             ((600, None), (2100, None)))
    return errs | {k: max(v, errs[k]) for k, v in wide.items()}, plans


def phase_decode_thresholds(rng, sm_mhz: float) -> dict:
    """Phase 3 at B2's row threshold (ops.tb_decode.STAGE_MIN_ROWS = 64
    packed rows; a traceback's rows are a multiple of four, so 60 is the
    largest shape below it), in both layouts: 64 pairs with two INF-score
    rows, decoded in their plan and in the other one forced, each equal to
    the plain version (time_banded).  -> the largest differences."""
    from claragenomicsanalysis_tpu_torch.ops import tb_decode
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    errs = {}
    for kernel, lengths in (("diag", (119, 120)), ("row", (240, 256))):
        for L in lengths:
            pairs = []
            for _ in range(62):
                a = rng.integers(0, 4, L)
                pairs.append((to_str(a), to_str(mutate(a, 4, rng))[:L]))
            a = to_str(rng.integers(0, 4, L))
            pairs += [(a, a[:5]), (a[:3], a)]       # INF at r = 16
            q, qlen, t, tlen = from_reference(*pack(pairs, L, L),
                                              device="cuda")[:4]
            per = time_banded(q, qlen, t, tlen, 16, sm_mhz,
                              f"phase 3 {kernel} threshold (L={L})", kernel)
            name = "tb_decode" if kernel == "diag" else "tb_decode_row"
            want = "staged" if L in (120, 256) else "thread"
            check(per[name]["plan"].startswith(want),
                  f"phase 3: {name} at L={L} took {per[name]['plan']}, not "
                  f"{want} (STAGE_MIN_ROWS={tb_decode.STAGE_MIN_ROWS})")
            errs[name] = max(errs.get(name, 0), per[name]["err"])
    return errs


#: B3's plans reached in phase 2: (radius, SMEM_PER_BLOCK or None); a
#: radius for each K = 1..8 band lanes a lane of the warp plan, 127 and 128
#: (W = 256 / 264, the warp / block switch), and the lowered SMEM_PER_BLOCK
#: moving a warp launch to reading q and t through L1 and a block launch to
#: device memory
NW_ROW_PLANS = ((1, None), (16, None), (40, None), (60, None), (72, None),
                (90, None), (100, None), (127, None), (128, None), (16, 600),
                (128, 600))


def phase_row_kernels(pairs, cases) -> dict:
    """B3 and B2's row decode against their plain versions on ``pairs`` at
    each (radius, SMEM_PER_BLOCK) of ``cases``: scores and the whole tb,
    packed paths and starts of the finite rows; the row route's scores and
    paths against B1's.  -> the largest differences seen."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, nw_row, tb_decode
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    q, qlen, t, tlen = from_reference(*pack(pairs), device="cuda")[:4]
    err_nw = err_tb = 0
    plain = {}      # a radius's plain outputs and B1's, once for its plans
    for r, limit in cases:
        with smem_forced(limit):
            plan = nw_row.nw_row_plan(q.shape[1], t.shape[1], r)
            s_k, tb_k = nw_row.banded_nw_row(q, qlen, t, tlen, r)
            torch.cuda.synchronize()
        if r not in plain:     # the decode on the plain tb, which the
            s_d, tb_d = nw_diag.banded_nw_diag(q, qlen, t, tlen, r)
            s_p, tb_p = nw_row.banded_nw_row_torch(q, qlen, t, tlen, r)
            plain[r] = (s_p, tb_p, tb_decode.decode_row_torch(
                tb_p, qlen, tlen, r), s_d,
                tb_decode.traceback_paths_device(tb_d, qlen, tlen, r))
        s_p, tb_p, (pp, sp), s_d, paths_d = plain[r]    # kernel's must equal
        d_s = int((s_k.long() - s_p.long()).abs().max())
        d_tb = int((tb_k.int() - tb_p.int()).abs().max())
        err_nw = max(err_nw, d_s, d_tb)
        ok = s_k < nw_row.INF
        pk, sk = tb_decode.decode_row(tb_k, qlen, tlen, r)
        torch.cuda.synchronize()
        d_p = int((pk[ok].long() - pp[ok].long()).abs().max())
        d_st = int((sk[ok].long() - sp[ok].long()).abs().max())
        err_tb = max(err_tb, d_p, d_st)
        paths = tb_decode.unpack_paths(pk.cpu().numpy(), sk.cpu().numpy())
        bad = [b for b in np.flatnonzero(ok.cpu().numpy())
               if paths[b] != paths_d[b]]
        W = nw_row.band_width_row(r)
        print(f"phase 2 nw_row r={r} plan {plan}: B={len(pairs)} "
              f"Lq={q.shape[1]} "
              f"Lt={t.shape[1]} W={W} finite={int(ok.sum())} "
              f"score_diff={d_s} tb_diff={d_tb}; "
              f"phase 3 tb_decode_row: packed_diff={d_p} start_diff={d_st}; "
              f"vs nw_diag: scores equal {torch.equal(s_k, s_d)}, "
              f"path_mismatches={len(bad)}")
        check(d_s == 0 and d_tb == 0,
              f"nw_row kernel disagrees with its plain version at r={r} "
              f"({plan})")
        check(("device" in plan[0]) == (limit is not None)
              and plan[0].startswith("warp" if r < 128 else "block"),
              f"nw_row at r={r}, SMEM_PER_BLOCK {limit}: plan {plan}")
        check(d_p == 0 and d_st == 0,
              f"tb_decode_row kernel disagrees with its plain version at "
              f"r={r}")
        check(torch.equal(s_k, s_d) and not bad,
              f"the row kernels differ from the diag kernels at r={r}")
    return {"nw_row": err_nw, "tb_decode_row": err_tb}


def phase_golden():
    """Phase 4: ``cli align --device cuda`` against the golden, with the
    aligner it makes built with each banded-NW kernel in turn (the CLI has
    no kernel option, as the JAX CLI has no backend one), launches
    counted."""
    from claragenomicsanalysis_tpu_torch import cli
    from claragenomicsanalysis_tpu_torch.models import aligner
    from claragenomicsanalysis_tpu_torch.utils.profiling import stage_times
    data = os.path.join(ROOT, "data")
    with open(os.path.join(data, "golden", "sample_align.txt")) as f:
        golden = f.read()
    create = aligner.create_aligner
    for kernel in ("diag", "row"):
        buf = io.StringIO()
        aligner.create_aligner = lambda *a, **k: create(*a, kernel=kernel,
                                                        **k)
        try:
            with contextlib.redirect_stdout(buf), stage_times() as st:
                rc = cli.main(["align", f"{data}/sample_queries.fasta",
                               f"{data}/sample_targets.fasta",
                               "--band-radius", "64", "--device", "cuda"])
        finally:
            aligner.create_aligner = create
        launches = read_launches(st)
        same = rc == 0 and buf.getvalue() == golden
        print(f"phase 4 golden: align --device cuda through create_aligner("
              f"..., kernel=\"{kernel}\") vs data/golden/sample_align.txt: "
              f"{'identical' if same else 'DIFFERENT'} "
              f"({len(golden.splitlines())} lines); launches={launches}")
        check(same, f"align output (kernel={kernel}) differs from "
              f"data/golden/sample_align.txt")
        used = ("nw_row", "tb_decode_row") if kernel == "row" else (
            "nw_diag", "tb_decode")
        check(all(launches[k] > 0 for k in used)
              and sum(launches.values()) == sum(launches[k] for k in used),
              f"kernel={kernel}: launches {launches}")


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


def run_aligner(pairs, algorithm: str, device="cuda", kernel="diag"):
    """Align ``pairs`` with a fresh aligner sized to them; -> (results,
    wall seconds of align_all + get_alignments, ended by a sync)."""
    import torch
    from claragenomicsanalysis_tpu_torch import create_aligner
    aligner = create_aligner(max(len(a) for a, _ in pairs),
                             max(len(b) for _, b in pairs), len(pairs),
                             band_radius=64, algorithm=algorithm,
                             device=device, kernel=kernel)
    for a, b in pairs:
        aligner.add_alignment(a, b)
    settle_heap()
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
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)

    n = len(pairs)
    max_q = max(len(a) for a, _ in pairs)
    max_t = max(len(b) for _, b in pairs)
    aligner = create_aligner(max_q, max_t, n, band_radius=64, device="cuda")
    for a, b in pairs:
        aligner.add_alignment(a, b)
    settle_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kernel_times() as kt, stage_times() as st:
        aligner.align_all()
        results = aligner.get_alignments()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(st)
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
                       "nw_row": 0, "tb_decode_row": 0, "myers": 0,
                       "cigar": 0},
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
    return {"results": results, "radius": radius, "kernels": per,
            "wall": wall}


def banded_kernels(kernel: str) -> tuple:
    """(names, kernel functions and plain versions) of one banded-NW
    route: the NW kernel and the decoder of its traceback layout."""
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, nw_row, tb_decode
    if kernel == "row":
        return (("nw_row", "tb_decode_row"), nw_row.banded_nw_row,
                nw_row.banded_nw_row_torch, tb_decode.decode_row,
                tb_decode.decode_row_torch, nw_row.band_width_row)
    return (("nw_diag", "tb_decode"), nw_diag.banded_nw_diag,
            nw_diag.banded_nw_diag_torch, tb_decode.decode_diag,
            tb_decode.decode_diag_torch, nw_diag.band_slots)


def time_banded(q, qlen, t, tlen, r: int, sm_mhz: float, tag: str,
                kernel: str = "diag", plain: dict | None = None) -> dict:
    """The banded-NW kernel of ``kernel`` (B1 or B3) and its layout's
    decoder (B2) against their plain versions on these inputs, exactly (NW:
    scores and the whole tb; decode: packed paths and starts, on the
    kernel's tb), with times (kernel: mean of 5 launches; plain: one call)
    and bounds: for the NW 7 int32 operations per band cell (the same cells
    for both kernels: they compute one function), q, t and the lengths read
    once, scores and tb written once; for the decode 16 operations per step
    of the walk, one tb byte read per step, the packed paths and starts
    written once.  The decode also runs in the plan its shape does not take
    (decode_forced), equal to the plain version too, into FORCED_PLANS.
    ``plain``, where given, keeps the plain versions' outputs and times of
    these inputs (a dict, filled on the first call), so that several plans
    of one kernel on them run the plain versions and the other decode plan
    once; the kernel's own outputs land in it as ``"kernel"``."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.ops import tb_decode
    (name_nw, name_tb), nw, nw_plain, dec, dec_plain, width = \
        banded_kernels(kernel)
    plain = {} if plain is None else plain
    first = "dec" not in plain
    ms_nw, (s_k, tb_k) = cuda_ms(lambda: nw(q, qlen, t, tlen, r), 5)
    if "nw" not in plain:
        plain["nw"] = cuda_ms(lambda: nw_plain(q, qlen, t, tlen, r), 1)
    ms_nw_plain, (s_p, tb_p) = plain["nw"]
    ms_tb, (pk_k, st_k) = cuda_ms(lambda: dec(tb_k, qlen, tlen, r), 5)
    if first:   # on the plain tb, which the kernel's must equal
        plain["dec"] = cuda_ms(lambda: dec_plain(tb_p, qlen, tlen, r), 1)
    ms_tb_plain, (pk_p, st_p) = plain["dec"]
    plain["kernel"] = (s_k, tb_k, pk_k, st_k)
    err_nw = max(int((s_k.long() - s_p.long()).abs().max()),
                 int((tb_k.int() - tb_p.int()).abs().max()))
    err_tb = max(int((pk_k.long() - pk_p.long()).abs().max()),
                 int((st_k.long() - st_p.long()).abs().max()))
    B = q.shape[0]
    shape = (f"B={B} Lq={q.shape[1]} Lt={t.shape[1]} r={r} "
             f"W={width(r)} tb={tuple(tb_k.shape)}")
    if kernel == "diag":
        from claragenomicsanalysis_tpu_torch.ops import nw_diag
        plan_nw = "/".join(map(str, nw_diag.nw_diag_plan(q.shape[1],
                                                         t.shape[1], r)))
    else:
        from claragenomicsanalysis_tpu_torch.ops import nw_row
        plan_nw = "/".join(map(str, nw_row.nw_row_plan(q.shape[1],
                                                       t.shape[1], r)))
    R4, _, W = tb_k.shape
    plan_tb = tb_decode.tb_decode_plan(B, R4, W, kernel)
    # the longest walk's steps, and the decode's cycles a step along it
    TL = 16 * pk_k.shape[1]
    walk = TL - int(st_k.min()) if B else 0
    cycles = ms_tb * 1e3 * sm_mhz / max(walk, 1)
    print(f"{tag} kernels ({shape}): {name_nw} ({plan_nw}) kernel "
          f"{ms_nw:.3f} ms vs plain {ms_nw_plain:.1f} ms (all {B} problems), "
          f"scores+tb max diff {err_nw}; {name_tb} ({'/'.join(map(str, plan_tb))}"
          f") kernel {ms_tb:.3f} ms = {cycles:.0f} cycles a step of the "
          f"longest walk ({walk} steps) vs plain {ms_tb_plain:.1f} ms, "
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
    print(f"{tag} bounds: {name_nw} {cells} band cells x "
          f"{OPS_PER_BAND_CELL} ops, {io_bytes + tb_k.numel()} B -> "
          f"{b_nw[0]:.4f} ms ({b_nw[1]}); {name_tb} {steps} steps x "
          f"{OPS_PER_WALK_STEP} ops -> {b_tb[0]:.4f} ms ({b_tb[1]})")
    if first and B:     # the decode in the plan its shape does not take
        other = "thread" if plan_tb[0] != "thread" else "staged"
        with decode_forced(other):
            forced = tb_decode.tb_decode_plan(B, R4, W, kernel)
            ms_o, (pk_o, st_o) = cuda_ms(lambda: dec(tb_k, qlen, tlen, r), 5)
        err_o = max(int((pk_o.long() - pk_p.long()).abs().max()),
                    int((st_o.long() - st_p.long()).abs().max()))
        print(f"{tag} {name_tb} forced into {'/'.join(map(str, forced))} "
              f"(the plan takes {plan_tb[0]}): {ms_o:.3f} ms, packed+start "
              f"max diff {err_o} vs the plain version")
        check(err_o == 0 and forced[0].startswith(other),
              f"{name_tb} in the forced plan {forced} disagrees with its "
              f"plain version ({tag}, {shape})")
        FORCED_PLANS[name_tb].append({
            "variant": f"{tag} forced {'/'.join(map(str, forced))}",
            "shape": shape, "ms": ms_o, "plain_ms": ms_tb_plain,
            "bound": b_tb, "err": err_o})
    return {name_nw: {"shape": shape, "plan": plan_nw, "ms": ms_nw,
                      "plain_ms": ms_nw_plain, "bound": b_nw, "err": err_nw},
            name_tb: {"shape": shape, "plan": "/".join(map(str, plan_tb)),
                      "ms": ms_tb, "plain_ms": ms_tb_plain, "bound": b_tb,
                      "err": err_tb, "cycles_a_step": cycles}}


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


#: query words of phase 6's batches that reach each lane count of B4 (G =
#: 1, 2, 4, 8, 16, 32) and one, two and three passes (ops.myers.myers_plan)
MYERS_PLAN_WORDS = (1, 5, 9, 17, 33, 65, 129, 513, 1100)
#: C9: the first query length past the first design's 4,096 words
C9_WORDS = 4097


def phase_myers_edges(rng, sm_mhz: float) -> tuple[int, dict]:
    """Phase 6: the Myers kernel against its plain version, whole rows and
    scores, on the edge batch, on batches whose query reaches each lane
    count and one to three passes, and (C9) at 4,097 query words (131,104
    bases, 9 passes) against a 2 kb target, timed with its bound.  ->
    (the largest difference, the C9 launch's figures)."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import myers
    from claragenomicsanalysis_tpu_torch.ops.convert import from_reference
    pairs = myers_edge_pairs(rng)
    batches = [("edge batch", pairs, None)]
    for words in MYERS_PLAN_WORDS:
        Lq = 32 * words
        b = []
        for n in (Lq, Lq - 1, max(1, Lq - 40), min(33, Lq), 1, 0):
            a = rng.integers(0, 4, n)
            b.append((to_str(a), to_str(mutate(a[:300], 12, rng))))
        batches.append((f"{words} words (G, K, passes = "
                        f"{myers.myers_plan(words)})", b, Lq))
    err = 0
    for name, batch, Lq in batches:
        q, qlen, t, tlen = from_reference(*pack(batch, Lq), device="cuda")[:4]
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

    # C9: 4,097 words against a short target, kernel and plain, then the
    # myers algorithm on the pair
    a = rng.integers(0, 4, C9_WORDS * 32)
    pair = [(to_str(a), to_str(mutate(a[50_000:52_000], 100, rng)))]
    q, qlen, t, tlen = from_reference(*pack(pair), device="cuda")[:4]
    c9 = time_myers(q, qlen, t, tlen, sm_mhz)
    print(f"phase 6 C9: myers at {c9['shape']} (plan G, K, passes = "
          f"{myers.myers_plan(C9_WORDS)}): kernel {c9['ms']:.3f} ms vs plain "
          f"{c9['plain_ms']:.1f} ms, rows+scores max diff {c9['err']}; "
          f"bound {c9['bound'][0]:.4f} ms ({c9['bound'][1]})")
    check(c9["err"] == 0, "C9: myers disagrees with its plain version at "
          "4,097 words")
    err = max(err, c9["err"])
    _, res, w = run_aligner(pair, "myers")
    check_paths(res, pair, "C9 myers")
    check(res[0].edit_distance == int(c9["scores"][0]),
          "C9: the myers distance differs from B4's plain score")
    print(f"phase 6 C9: the myers algorithm on the {len(pair[0][0])} x "
          f"{len(pair[0][1])} pair in {w:.3f} s: SUCCESS, distance "
          f"{res[0].edit_distance} == the plain score")
    return err, dict(c9, variant=f"{C9_WORDS} query words, "
                     f"{myers.myers_plan(C9_WORDS)[2]} passes")


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
    wq = -(-q.shape[1] // 32)
    return {"ms": ms_k, "plain_ms": ms_p, "err": err, "words": words,
            "plan": "/".join(map(str, myers.myers_plan(wq))),
            "Lt": Lt, "cells": 32 * words * Lt, "scores": s_k.cpu().numpy(),
            "bound": bound(OPS_PER_MYERS_WORD * words * Lt, nbytes, sm_mhz),
            "shape": f"B={B} Lq={q.shape[1]} Lt={Lt} "
                     f"Wq={-(-q.shape[1] // 32)}"}


def time_cigar(words, seg_base, seg_first, seg_end, path_seg,
               sm_mhz: float) -> dict:
    """The CIGAR kernel against its plain version on these inputs: the text
    equal byte for byte, times (kernel: its count and write passes by CUDA
    events, each the mean of 5 launches, the scan and the read-back of the
    total between them untimed; plain: one call on CPU copies) and the
    bound (bytes: the segments' codes read once at 2 bits, the segment
    table and path offsets read once, the text written once)."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import cigar
    args = (words, seg_base, seg_first, seg_end, path_seg)
    dev, P, S = words.device, path_seg.numel() - 1, seg_base.numel()
    letters = cigar._letters(False)
    counts = torch.empty(P, dtype=torch.int64, device=dev)
    none = torch.empty(0, dtype=torch.uint8, device=dev)
    ms_count, _ = cuda_ms(lambda: cigar._launch(args, counts, none, P,
                                                letters, False), 5)
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    offsets[1:] = counts.cumsum(0)
    text = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=dev)
    ms_write, _ = cuda_ms(lambda: cigar._launch(args, offsets, text, P,
                                                letters, True), 5)
    t0 = time.perf_counter()
    plain = cigar.cigar_text_torch(*(a.cpu() for a in args))
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = text.cpu()
    err = (int((got != plain).sum()) if got.shape == plain.shape
           else abs(got.numel() - plain.numel()) + 1)
    codes = int((seg_end - seg_first.clamp(min=0)).clamp(min=0).sum())
    nbytes = codes / 4 + 24 * S + 8 * (P + 1) + text.numel()
    return {"ms": ms_count + ms_write, "plain_ms": plain_ms, "err": err,
            "plan": "warp/4", "bound": bound(0, nbytes, sm_mhz),
            "count_ms": ms_count, "write_ms": ms_write,
            "shape": f"P={P} S={S} codes={codes} text={text.numel()}"}


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
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)

    n = len(pairs)
    aligner = create_aligner(max(len(a) for a, _ in pairs),
                             max(len(b) for _, b in pairs), n,
                             band_radius=64, algorithm="myers",
                             device="cuda")
    for a, b in pairs:
        aligner.add_alignment(a, b)
    settle_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kernel_times() as kt, stage_times() as st:
        aligner.align_all()
        results = aligner.get_alignments()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(st)
    n_hirsch, levels = read_hirschberg(st)
    peak = torch.cuda.max_memory_allocated()
    bases = sum(len(a) + len(b) for a, b in pairs)
    print(f"phase 7 main path (myers): {n} alignments in {wall:.3f} s = "
          f"{n / wall:.1f} alignments/s = {bases / wall / 1e6:.2f} Mbp/s "
          f"(query + target) end to end; launches={launches}; routes: "
          f"{n_hirsch} Hirschberg, {n - n_hirsch} banded (padded Lq="
          f"{aligner.config.padded_query_length}); Hirschberg levels="
          f"{levels}; max_memory_allocated={peak} B")
    check(all(launches[k] > 0 for k in ("nw_diag", "tb_decode", "myers"))
          and launches["nw_row"] == launches["tb_decode_row"] == 0,
          f"a kernel of the myers path never launched, or a row kernel "
          f"did: {launches}")
    check(n_hirsch == n and launches["myers"] == 1 + levels,
          "at a padded query length over 2,048 every pair must go to "
          "Hirschberg, with one Myers launch per level after the score pass")
    check(kt.count() == {k: v for k, v in launches.items() if v},
          f"timed launches {kt.count()}")
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
        print(f"phase 7 myers at the {name}: {c['ms']:.3f} ms against the "
              f"first design's {FIRST_MYERS_MS.get(name, float('nan')):.3f} "
              f"ms (recorded in PERF.md, not this run)")
    largest = max(calls, key=lambda k: calls[k]["cells"])
    print(f"phase 7 largest Myers call by work: the {largest}")
    per["myers"] = dict(calls[largest], err=max(c["err"]
                                                for c in calls.values()))
    for k, n_launch in launches.items():
        per.setdefault(k, {}).update(launches=n_launch,
                                     run_ms=dev_ms.get(k, 0.0))

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
        with stage_times() as st:
            _, res, w = run_aligner(sub, algorithm)
        same = all((r.path, r.edit_distance) == (m.path, m.edit_distance)
                   for r, m in zip(res, results))
        print(f"phase 7 {algorithm} on {len(sub)} of these pairs: "
              f"{w:.3f} s, routed to Hirschberg {read_hirschberg(st)[0]}, "
              f"paths and distances equal myers': {same}")
        check(same, f"{algorithm} differs from myers on the subset")
    return per, results


def phase_short_reads():
    """Phase 8: 0.5-1 kb pairs, where the rule keeps pairs banded."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.utils.profiling import stage_times
    pairs = main_path_pairs(N_SHORT, SEED + 2, 500, 1000)
    out = {}
    for algorithm in ("ukkonen", "myers", "banded-escalate"):
        with stage_times() as st:
            aligner, res, w = run_aligner(pairs, algorithm)
        routed = read_hirschberg(st)[0]
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


def phase_c8_align(sm_mhz: float) -> dict:
    """Phase 17 (C8, aligner): a pair whose lengths differ by 16,385 (1,000
    bases against 16,385 N and their 1,000-base source, 5 % edits) through
    all four algorithms
    and both banded kernels: ``ukkonen`` gives it r = 32,832 (B1's and B3's
    device-memory variants, B3 at W = 65,672 in two lane groups), the other
    three go to Hirschberg, whose first base case (about 32 query bases
    against the N run) runs B1 (or B3) at r = 32,768 on device memory.  Each result is a SUCCESS path at its
    distance; the distances are equal, the diag and row routes give the
    same paths, and ``hirschberg-myers`` equals the plain versions
    (device="cpu").  Then each kernel at ``ukkonen``'s launch (its only
    one, so its result is the decode of that traceback) and at Hirschberg's
    largest base case against its plain version on the card, exactly,
    timed with its bound.  -> kernel name -> a list of variant figures."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.ops import nw_diag, nw_row
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)
    rng = np.random.default_rng(SEED + 17)
    # the target is 16,385 N (which match nothing) and then the query's
    # source: every optimal path deletes the N first, so Hirschberg's first
    # fragment (about 32 query bases) holds them all
    source = rng.integers(0, 4, 1_100)
    query = mutate(source, 55, rng)[:1_000]
    pair = [(to_str(query), "N" * 16_385 + to_str(source[:1_000]))]
    check(len(pair[0][1]) - len(pair[0][0]) == 16_385, "C8 pair lengths")
    out, largest = {}, {}
    for algorithm in ("ukkonen", "myers", "hirschberg-myers",
                      "banded-escalate"):
        for kernel in ("diag", "row"):
            with kernel_times() as kt, stage_times() as st:
                _, res, w = run_aligner(pair, algorithm, kernel=kernel)
            check_paths(res, pair, f"C8 {algorithm} {kernel}")
            out[(algorithm, kernel)] = res[0]
            name = "nw_row" if kernel == "row" else "nw_diag"
            args = kt.largest[name]
            if algorithm in ("ukkonen", "hirschberg-myers"):
                largest[(name, algorithm)] = args
            print(f"phase 17 C8 {algorithm} (kernel=\"{kernel}\"): "
                  f"{w:.3f} s, distance {res[0].edit_distance}, launches "
                  f"{read_launches(st)}, largest {name} launch r={args[4]} "
                  f"B={args[0].shape[0]} Lq={args[0].shape[1]} "
                  f"Lt={args[2].shape[1]}")
    dists = {r.edit_distance for r in out.values()}
    check(len(dists) == 1, f"C8: the distances differ: {dists}")
    for algorithm in ("ukkonen", "myers", "hirschberg-myers",
                      "banded-escalate"):
        check(out[(algorithm, "diag")].path == out[(algorithm, "row")].path,
              f"C8 {algorithm}: the row route differs from the diag route")
    check(out[("myers", "diag")].path == out[("hirschberg-myers",
                                               "diag")].path
          == out[("banded-escalate", "diag")].path,
          "C8: the three Hirschberg routes differ")
    for algorithm in ("hirschberg-myers",):
        t0 = time.perf_counter()
        _, res, _ = run_aligner(pair, algorithm, device="cpu")
        same = (res[0].path, res[0].edit_distance) == (
            out[(algorithm, "diag")].path,
            out[(algorithm, "diag")].edit_distance)
        print(f"phase 17 C8 {algorithm} on the plain versions (device="
              f"\"cpu\", {time.perf_counter() - t0:.1f} s): equal to the "
              f"card's: {same}")
        check(same, f"C8 {algorithm}: the card differs from the plain "
              f"versions")
    variants = {}
    for (name, algorithm), (q, qlen, t, tlen, r) in largest.items():
        kernel = "row" if name == "nw_row" else "diag"
        Lq, Lt = q.shape[1], t.shape[1]
        plan = (nw_diag.nw_diag_plan(Lq, Lt, r) if kernel == "diag"
                else nw_row.nw_row_plan(Lq, Lt, r))[0]
        check("device" in plan, f"C8 {algorithm}: {name}'s largest launch "
              f"(r={r}, Lq={Lq}, Lt={Lt}) is not on device memory: {plan}")
        per = time_banded(q, qlen, t, tlen, r, sm_mhz,
                          f"phase 17 C8 {algorithm} {name} {plan}:", kernel)
        for k, v in per.items():
            variants.setdefault(k, []).append(dict(
                v, variant=f"C8 {algorithm}, |lq - lt| = 16,385: {plan}"))
    print(f"phase 17 C8: all four algorithms, both kernels: SUCCESS paths "
          f"at distance {dists.pop()}, diag == row, equal to the plain "
          f"versions")
    return variants


# ------------------------------------------------------------------ POA

POA_CAPS = dict(max_sequence_size=32, max_sequences_per_poa=6,
                max_pred_per_node=2, max_aligned_per_node=2,
                max_nodes_per_window=40)
#: models/correct.py's polish batch at CorrectConfig()'s window_length=128
#: and max_support=7 (depth 8)
POA_CORR = dict(max_sequence_size=256, max_nodes_per_window=384,
                max_sequences_per_poa=8, max_pred_per_node=8,
                max_aligned_per_node=4)
#: scripts/bench_all.py's deep pileups
POA_DEEP = dict(max_sequence_size=512, max_sequences_per_poa=16,
                max_pred_per_node=16, max_aligned_per_node=8,
                max_nodes_per_window=1024)
#: scripts/bench_poa_v2.py's default configuration, the one it measures with
#: --msa
POA_MSA = dict(max_sequence_size=128, max_sequences_per_poa=8,
               max_pred_per_node=4, max_aligned_per_node=4,
               max_nodes_per_window=256)
N_POA = 4096             # correction-shape windows (phases 12, 14, 15)
N_POA_DEEP = 512         # deep windows (phase 13)
#: the three POA main paths' windows (phases 12-14): (tag, BatchSize
#: keywords, windows, backbone bases, edits, banded, MSA)
POA_SHAPES = (("correction", POA_CORR, N_POA, 128, 6, False, False),
              ("deep", POA_DEEP, N_POA_DEEP, 256, 12, True, False),
              ("msa", POA_MSA, N_POA, 100, 5, False, True))
N_POA_PLAIN = 64         # windows re-run through the plain path on the CPU
MIN_OK_MSA = 0.97        # share of phase 14's windows that must be SUCCESS
# int32 operations per unit of work, counted for the POA bounds (PERF.md)
OPS_NW_CELL = 6          # B5 per live cell, plus 2 per pred slot read
OPS_ADD_STEP = 20        # B6 per base taken, plus 2 per filled pred and
                         # clique slot of the node it lands on
OPS_NODE = 4             # B7 / B8 / B9 per active node, plus 2 per pred slot
OPS_MSA_STEP = 4         # B9 per path step of a sequence


def tensors_of(x) -> tuple:
    """The tensors of a kernel's output: a tuple as it is, a graph state
    without the fields it does not carry."""
    return x.tensors() if hasattr(x, "tensors") else tuple(x)


def maxdiff(a, b) -> int:
    """Largest absolute difference over two tuples of integer tensors (or
    two graph states)."""
    return max((int((x.long() - y.long()).abs().max()) if x.numel() else 0)
               for x, y in zip(tensors_of(a), tensors_of(b), strict=True))


def poa_window_arrays(n: int, blen: int, depth: int, edits: int, L: int,
                      seed: int):
    """n windows, each ``depth`` copies of a seeded ``blen``-base backbone
    with ``edits`` random edits (weights 1): (backbones, windows as strings,
    seqs/weights (n, depth, L), lens (n, depth), n_seqs (n,)) NumPy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seqs = np.full((n, depth, L), -1, np.int32)
    lens = np.zeros((n, depth), np.int32)
    backbones, windows = [], []
    for wi in range(n):
        b = rng.integers(0, 4, blen).astype(np.int32)
        backbones.append(to_str(b))
        win = []
        for si in range(depth):
            m = mutate(b, edits, rng)[:L]
            seqs[wi, si, :len(m)] = m
            lens[wi, si] = len(m)
            win.append(to_str(m))
        windows.append(win)
    weights = (seqs >= 0).astype(np.int32)
    return backbones, windows, (seqs, weights, lens,
                                np.full(n, depth, np.int32))


def live_slots(nc, npred, pred):
    """Active nodes (W, N) and their filled pred slots (W, N, P)."""
    import torch
    W, N, P = pred.shape
    act_n = torch.arange(N, device=nc.device)[None, :] < nc[:, None]
    slot = (torch.arange(P, device=nc.device)[None, None, :]
            < npred[:, :, None]) & act_n[:, :, None]
    return act_n, slot


def work_nwtb(args, out=None):
    """B5: the DP over the (row, column) cells the band leaves (every column
    0..slen without one), then the end cell and the path."""
    import torch
    seq, order, rank, npred, base, nsucc, pred, slen, nc, alive = args[:10]
    band_width = args[11]
    W, N, P = pred.shape
    act_n, slot = live_slots(nc, npred, pred)
    rows = act_n & alive[:, None]
    r = torch.arange(N, device=nc.device)[None, :]
    lo = torch.zeros_like(rows, dtype=torch.int64)
    hi = slen[:, None].long().expand(W, N)
    if band_width > 0:
        c = torch.div((r + 1) * slen[:, None], nc[:, None] + 1,
                      rounding_mode="floor")
        lo = (c - band_width // 2).clamp(min=0)
        hi = torch.minimum(c + band_width // 2, hi)
    width = torch.where(rows, (hi - lo + 1).clamp(min=0), 0)
    npred_r = npred.gather(1, order.long())        # row r is node order[r]
    cells = int(width.sum())
    TL = N + seq.shape[1]
    return (int((width * (OPS_NW_CELL + 2 * npred_r)).sum()),
            4 * (5 * int(rows.sum()) + int((slot & rows[:, :, None]).sum())
                 + int(torch.where(alive, slen, 0).sum())) + 8 * W * TL
            + 17 * W,
            f"{cells} cells in the band" if band_width > 0
            else f"{cells} live cells")


def work_add(args, out=None):
    """B6: each path step from k0 reads pn and pp; a step that takes a base
    also reads it and its weight, reads the line of the node it lands on (5
    words, its filled pred and predw slots and clique members; none for a
    new node) and writes 5 words (cov, npred, a pred slot and its weight,
    the previous node's nsucc); with the MSA's paths, the sequence's row
    (L words) is written too."""
    import torch
    state, pn, pp, seq, weights, k0, act = args[:7]
    W, TL = pn.shape
    on = act[:, None] & (torch.arange(TL, device=k0.device)[None, :]
                         >= k0[:, None])
    take = on & (pp >= 0)
    old = take & (pn >= 0)
    node = pn.clamp(min=0).long()
    preds, clique = (int(torch.where(old, t.gather(1, node), 0).sum())
                     for t in (state.npred, state.nalig))
    steps, takes = int(on.sum()), int(take.sum())
    row = 0 if state.paths is None else 4 * seq.shape[1] * int(act.sum())
    return (OPS_ADD_STEP * takes + 2 * (preds + clique),
            8 * steps + 28 * takes
            + 4 * (5 * int(old.sum()) + 2 * preds + clique) + 21 * W + row,
            f"{steps} path steps, {takes} bases")


def work_topsort(args, out=None):
    """B7: longest-path levels in one pass in topological order (each node
    once, each filled pred slot once), then each node placed once."""
    level, npred, pred, nc = args[:4]
    act_n, slot = live_slots(nc, npred, pred)
    nodes, edges = int(act_n.sum()), int(slot.sum())
    W, N = npred.shape
    return (OPS_NODE * nodes + 2 * edges,
            4 * (2 * nodes + edges + W) + 12 * W * N + 4 * W,
            f"{nodes} nodes, {edges} edges")


def work_consensus(args, out):
    """B8: each node's score once in topological order (the max weight over
    its filled slots, the max score over the tied ones), then the backtrack,
    one step (and one base and coverage read) per consensus base."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops.poa_state import NEG
    npred, pred, predw, base, cov, rank, nc, MC = args
    act_n, slot = live_slots(nc, npred, pred)
    W, N = npred.shape
    w = torch.where(slot, predw, NEG)
    tie = slot & (w == w.max(2).values[:, :, None])
    nodes, edges = int(act_n.sum()), int(slot.sum())
    length = int(out[2].sum())
    return (OPS_NODE * nodes + 2 * edges + 2 * int(tie.sum()) + length,
            4 * (2 * nodes + 2 * length + 2 * edges + W) + 8 * W * MC + 4 * W,
            f"{nodes} nodes, {edges} edges")


def work_msa(args, out):
    """B9: one pass in rank order (each active node once, each filled pred
    slot of a clique's members once), then one step per position of every
    sequence's path.  Reads the four per-node words of active nodes (order,
    npred, nalig, base), the filled pred and clique slots and the paths'
    real entries; writes rows and n_cols whole."""
    import torch
    state, order = args
    act_n, slot = live_slots(state.node_count, state.npred, state.pred)
    nodes, edges = int(act_n.sum()), int(slot.sum())
    clique = int(torch.where(act_n, state.nalig, 0).sum())
    steps = int((state.paths >= 0).sum())
    W = order.shape[0]
    return (OPS_NODE * nodes + 2 * edges + OPS_MSA_STEP * steps,
            4 * (4 * nodes + edges + clique + steps + W)
            + 4 * out[0].numel() + 4 * W,
            f"{nodes} nodes, {edges} edges, {steps} path steps")


#: kernel name -> (its name in ops.poa_window, its plain version's there,
#: the function that counts its work)
POA_STEPS = {
    "poa_topsort": ("topsort", "topsort_torch", work_topsort),
    "poa_nwtb": ("graph_nw_traceback", "graph_nw_traceback_torch",
                 work_nwtb),
    "poa_add": ("add_alignment", "add_alignment_torch", work_add),
    "poa_consensus": ("consensus", "consensus_torch", work_consensus),
    "poa_msa": ("msa_rows", "msa_torch", work_msa),
}


@contextlib.contextmanager
def probe_poa(compare: bool, count_work: bool = False):
    """Inside the block, the lockstep loop's five kernel calls still launch
    their kernels and, with ``compare``, also run their plain versions on
    the same inputs; with ``count_work`` every call's int32 operations are
    counted.  Yields {"err": the largest difference seen, "cells": the real
    graph-NW cells, alive node_count * (slen + 1) per add, "ops": the
    operations of all calls}."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    stats = {"err": 0, "cells": 0, "ops": 0}
    kernels = {k: getattr(poa_window, name)
               for k, (name, _, _) in POA_STEPS.items()}

    def probe(k):
        _, plain, work = POA_STEPS[k]

        def run(*args):
            out = kernels[k](*args)
            if compare:
                torch.cuda.synchronize()
                stats["err"] = max(stats["err"], maxdiff(
                    out, getattr(poa_window, plain)(*args)))
            if count_work:
                stats["ops"] += work(args, out)[0]
            if k == "poa_nwtb":
                slen, nc, alive = args[7:10]
                stats["cells"] += int((alive.long() * nc.clamp(
                    max=args[1].shape[1]) * (slen + 1)).sum())
            return out
        return run

    for k, (name, _, _) in POA_STEPS.items():
        setattr(poa_window, name, probe(k))
    try:
        yield stats
    finally:
        for k, (name, _, _) in POA_STEPS.items():
            setattr(poa_window, name, kernels[k])


def run_poa_arrays(bs, banded: bool, arrays, compare: bool,
                   msa: bool = False, count_work: bool = False,
                   scores=None):
    """ops.poa_window.run_windows (the lockstep route) on these windows,
    all in one launch per step, under probe_poa -> (its seven outputs, the
    probe's stats)."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import PoaScores
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    with probe_poa(compare, count_work) as stats:
        out = poa_window.run_windows(
            bs, scores or PoaScores(), banded,
            *(torch.as_tensor(a).cuda() for a in arrays), msa)
    return out, stats


def phase_poa_kernels() -> int:
    """Phase 10: B7, B5, B6 (writing the MSA's paths), B8 and B9 against
    their plain versions at every launch of a 5-add run, arrays equal, under
    tight caps (node, clique and edge overflows all hit), full and banded;
    the batch holds an empty window, an empty first sequence, N bases, a
    first sequence over max_nodes_per_window and a 2-node graph against 60
    bases.  Then B10 on the same windows, with and without the MSA, against
    the lockstep loop over the plain versions in each of its plans
    (WINDOW_PLANS) and on 8-byte plane words: its six outputs equal."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.ops import poa_nwtb, poa_window
    errs = {}
    for banded in (False, True):
        bs = BatchSize(**POA_CAPS, band_width=16 if banded else 256)
        S, L = bs.max_sequences_per_poa, bs.padded_seq
        _, _, (seqs, weights, lens, n_seqs) = poa_window_arrays(
            64, 24, S, 8, L, SEED + 10 + banded)
        seqs[1, 1:3, 5:8] = -1                  # N bases inside sequences
        n_seqs[2] = 0                           # an empty window
        seqs[2], lens[2] = -1, 0
        seqs[3, 0], lens[3, 0] = -1, 0          # an empty first sequence
        long_first = np.random.default_rng(SEED).integers(0, 4, 44)
        seqs[4, 0, :44], lens[4, 0] = long_first, 44   # over max_nodes 40
        # a 2-node graph against 60 bases: banded, sums on NEG
        seqs[5, 0, :2], lens[5, 0] = long_first[:2], 2
        seqs[5, 1, :60], lens[5, 1] = np.resize(long_first, 60), 60
        weights = ((seqs >= 0) * (1 + np.arange(L) % 3)).astype(np.int32)
        arrays = (seqs, weights, lens, n_seqs)
        out, probed = run_poa_arrays(bs, banded, arrays, True, msa=True)
        statuses = sorted(set(out[5].tolist()))
        kind = "banded, width 16" if banded else "full"
        print(f"phase 10 poa kernels ({kind}"
              f", 64 windows, S={S} P=2 A=2 N={bs.padded_nodes}): every "
              f"launch of B7/B5/B6/B8/B9 (the MSA's paths on) vs its plain "
              f"version, max diff {probed['err']}; final statuses {statuses}")
        check(probed["err"] == 0,
              "a POA kernel disagrees with its plain version")
        check({0, 23, 24, 28} <= set(statuses),
              "the edge batch must reach SUCCESS, node and edge overflow and "
              "the band status")
        err_w = 0
        dev = [torch.from_numpy(a).cuda() for a in arrays]
        for sc in (PoaScores(), PoaScores(*WIDE_SCORES)):
            for msa in (False, True):
                args = (*dev, bs, sc, banded, msa)
                want = poa_window.poa_window_torch(*args)
                for variant, ring in WINDOW_PLANS:
                    with window_forced(variant, ring):
                        word = poa_nwtb.nwtb_word_bytes(bs.padded_nodes, L,
                                                        sc)
                        plan = poa_window.window_plan(
                            64, bs, bs.band_width if banded else 0, word)
                        check(plan[::2] == (variant, ring)
                              and word == (4 if sc == PoaScores() else 8),
                              f"B10 got the plan {plan}, {word}-byte words")
                        got = poa_window.poa_window(*args)
                        torch.cuda.synchronize()
                    err_w = max(err_w, maxdiff(got, want))
                    if msa and sc == PoaScores():   # and the lockstep
                        err_w = max(err_w, maxdiff(got, out[:6]))
        print(f"phase 10 poa_window ({kind}): B10's six outputs in each "
              f"plan {WINDOW_PLANS}, 4- and 8-byte plane words, with and "
              f"without the MSA, vs the lockstep loop over the plain "
              f"versions (and vs the lockstep kernels), max diff {err_w}")
        check(err_w == 0, "the one-kernel-per-window POA disagrees with its "
              "plain version")
        errs[banded] = max(probed["err"], err_w)
    return max(max(errs.values()), phase_add_edges(), phase_topsort_edges(),
               phase_finish_edges())


def phase_topsort_edges() -> int:
    """Phase 10, B7's edges: every topsort launch of a lockstep run at a
    small deep-like shape (16 pred slots, banded) replayed with its hint,
    with a hint wrong on purpose (nc_pre 0: every node new; nc_pre =
    node_count: every node old) and on a window given a cycle, each in
    each plan of ops.poa_topsort.topsort_plan (4, 2 and 1 windows a block,
    the tables in device scratch) against the plain version.  -> the
    largest difference."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.ops import (_build, poa_topsort,
                                                     poa_window)
    bs = BatchSize(max_sequence_size=64, max_sequences_per_poa=10,
                   max_pred_per_node=16, max_aligned_per_node=8,
                   band_width=24)
    S, L, N = bs.max_sequences_per_poa, bs.padded_seq, bs.padded_nodes
    _, _, arrays = poa_window_arrays(48, 56, S, 5, L, SEED + 70)
    calls, orig = [], poa_window.topsort

    def spy(*args):
        calls.append(tuple(a.clone() for a in args))
        return orig(*args)

    poa_window.topsort = spy
    try:
        poa_window.run_windows(bs, PoaScores(), True,
                               *(torch.as_tensor(a).cuda() for a in arrays))
    finally:
        poa_window.topsort = orig
    cases = []
    for level, npred, pred, nc, nc_pre in calls:
        cases += [("hint", (level, npred, pred, nc, nc_pre)),
                  ("nc_pre 0", (level, npred, pred, nc, torch.zeros_like(nc))),
                  ("nc_pre nc", (level, npred, pred, nc, nc))]
    level, npred, pred, nc, nc_pre = calls[-1]
    cyc_pred, cyc_npred = pred.clone(), npred.clone()
    a, b = 5, 9                  # window 0: b's pred a, a's pred b
    cyc_pred[0, a, 0], cyc_pred[0, b, 0] = b, a
    cyc_npred[0, [a, b]] = cyc_npred[0, [a, b]].clamp(min=1)
    cases.append(("cycle", (level, cyc_npred, cyc_pred, nc, nc_pre)))
    per = poa_topsort.topsort_table_bytes(N)
    err, cyclic_ok = 0, None
    wants = [poa_topsort.topsort_torch(*args) for _, args in cases]
    for limit, want_plan in ((None, ("warp-shared", 4)),
                             (2 * per, ("warp-shared", 2)),
                             (per, ("warp-shared", 1)),
                             (per - 1, ("warp-device", 4))):
        with smem_forced(limit):
            plan = poa_topsort.topsort_plan(N)
            check(plan == want_plan, f"B7 edges: plan {plan} at "
                  f"SMEM_PER_BLOCK {limit}")
            for (name, args), want in zip(cases, wants):
                got = poa_topsort.topsort(*args)
                torch.cuda.synchronize()
                err = max(err, maxdiff(got, want))
                if name == "cycle":
                    cyclic_ok = bool(got[3][0])
        print(f"phase 10 poa_topsort edges (N={N} P={bs.max_pred_per_node}, "
              f"{len(calls)} lockstep launches x the hint, nc_pre 0 and "
              f"nc_pre = node_count, and a window with a cycle), plan "
              f"{plan}: max diff {err} vs the plain version; the cyclic "
              f"window's ok {cyclic_ok}")
        check(err == 0, f"B7 disagrees with its plain version ({plan})")
        check(cyclic_ok is False, "B7: a cyclic window must not be ok")
    check(np.unique([c[1][3].sum().item() for c in cases]).size > 1,
          "B7 edges: the lockstep run added no node")
    return err


def finish_calls(bs, banded: bool, arrays) -> tuple:
    """The consensus and MSA calls of a lockstep run with the MSA on the
    card: (consensus args, (state, order))."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import PoaScores
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    seen = {}
    orig = {k: getattr(poa_window, k) for k in ("consensus", "msa_rows")}

    def spy(k):
        def run(*args):
            seen[k] = args
            return orig[k](*args)
        return run

    for k in orig:
        setattr(poa_window, k, spy(k))
    try:
        poa_window.run_windows(bs, PoaScores(), banded,
                               *(torch.as_tensor(a).cuda() for a in arrays),
                               True)
    finally:
        for k, f in orig.items():
            setattr(poa_window, k, f)
    return seen["consensus"], seen["msa_rows"]


def phase_finish_edges() -> int:
    """Phase 10, B8's and B9's plans: the consensus and MSA calls of two
    lockstep runs (tight caps, where node, clique and edge overflows hit,
    and a small deep-like banded run), and the deep-like call with a
    window given a cycle and with a rank that is no permutation, each in
    every plan of ops.poa_consensus.consensus_plan (4, 2 and 1 windows a
    block, the tables in device scratch) and ops.poa_msa.msa_plan (4, 2
    and 1 windows a block, the columns alone in shared memory, both tables
    in device scratch) against the plain versions.  -> the largest
    difference."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import BatchSize
    from claragenomicsanalysis_tpu_torch.ops import poa_consensus, poa_msa
    deep = BatchSize(max_sequence_size=64, max_sequences_per_poa=10,
                     max_pred_per_node=16, max_aligned_per_node=8,
                     band_width=24)
    caps = BatchSize(**POA_CAPS)
    cons, msas = [], []
    for bs, banded, seed in ((caps, False, SEED + 80), (deep, True,
                                                        SEED + 81)):
        _, _, arrays = poa_window_arrays(48, bs.max_sequence_size - 8,
                                         bs.max_sequences_per_poa, 5,
                                         bs.padded_seq, seed)
        c, m = finish_calls(bs, banded, arrays)
        cons.append(("lockstep", c))
        msas.append(m)
    npred, pred, predw, base, cov, rank, nc, MC = cons[-1][1]
    cyc_pred, cyc_npred = pred.clone(), npred.clone()
    cyc_pred[0, 5, 0], cyc_pred[0, 9, 0] = 9, 5   # window 0: 5 <-> 9
    cyc_npred[0, [5, 9]] = cyc_npred[0, [5, 9]].clamp(min=1)
    cons.append(("cycle", (cyc_npred, cyc_pred, predw, base, cov, rank, nc,
                           MC)))
    dup = rank.clone()
    dup[:, 3] = dup[:, 4]                         # no permutation
    cons.append(("rank no permutation", (npred, pred, predw, base, cov, dup,
                                         nc, MC)))
    err, seen = 0, set()
    for name, args in cons:
        W, N, P = args[1].shape
        want = poa_consensus.consensus_torch(*args)
        per = poa_consensus.consensus_table_bytes(N, args[7])
        for limit in (None, 2 * per, per, per - 1):
            with smem_forced(limit):
                plan = poa_consensus.consensus_plan(W, N, P, args[7])
                got = poa_consensus.consensus(*args)
                torch.cuda.synchronize()
            err = max(err, maxdiff(got, want))
            seen.add(("B8", plan))
    for state, order in msas:
        W, N, P = state.pred.shape
        A, (S, L) = state.alig.shape[2], state.paths.shape[1:]
        want = poa_msa.msa_torch(state, order)
        per = poa_msa.msa_table_bytes(N, P, A)
        for limit in (None, 2 * per, per, 4 * N, 4 * N - 4):
            with smem_forced(limit):
                plan = poa_msa.msa_plan(W, N, P, A, S, L)
                got = poa_msa.msa(state, order)
                torch.cuda.synchronize()
            err = max(err, maxdiff(got, want))
            seen.add(("B9", plan))
    plans = sorted(seen)
    print(f"phase 10 poa_consensus / poa_msa plans: B8 on the consensus "
          f"calls of a tight-caps and a deep-like lockstep run, a cyclic "
          f"window and a rank that is no permutation, B9 on both runs' MSA "
          f"calls, each in {plans}: max diff {err} vs the plain versions")
    check(err == 0, "B8 or B9 disagrees with its plain version in a plan")
    check(len(plans) == 9, f"B8 / B9 plans held: {plans}")
    return err


#: B6 edge batches of phase 10: (A, P, sequences a window, max nodes or None
#: for the default, MSA); every added sequence has an N at position 6 (an N
#: matches no node, so each makes a new node beside the clique there, and
#: the next node's preds grow): A = 1; A + 1 = 32, 33 and 64 (a clique's
#: members spill into a lane's second register past 32); P = 33 and 64 (the
#: pred slots into a second lane chunk); P = 1 (the edge overflow); a node
#: overflow
ADD_EDGES = ((1, 4, 6, None, False), (31, 40, 48, None, True),
             (32, 33, 56, None, False), (63, 64, 56, None, True),
             (4, 1, 8, None, False), (4, 8, 8, 30, True))


def phase_add_edges() -> int:
    """Phase 10, B6's edges (ADD_EDGES): every lockstep launch of each
    batch against the plain versions; the cliques and pred rows the batches
    must fill, and the overflow statuses, checked.  -> the largest
    difference."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch.core.config import BatchSize
    err, statuses = 0, set()
    for i, (A, P, S, max_nodes, msa) in enumerate(ADD_EDGES):
        bs = BatchSize(max_sequence_size=24, max_sequences_per_poa=S,
                       max_pred_per_node=P, max_aligned_per_node=A,
                       max_nodes_per_window=max_nodes or 400)
        L = bs.padded_seq
        _, _, (seqs, weights, lens, n_seqs) = poa_window_arrays(
            4, 20, S, 2, L, SEED + 60 + i)
        seqs[:, 1:, 6] = -1
        seqs[1, 1::2, 9] = -1
        weights = ((seqs >= 0) * (1 + np.arange(L) % 3)).astype(np.int32)
        out, probed = run_poa_arrays(bs, False, (seqs, weights, lens,
                                                 n_seqs), True, msa)
        err = max(err, probed["err"])
        st = out[6]
        nalig, npred = int(st.nalig.max()), int(st.npred.max())
        statuses |= set(st.status.tolist())
        print(f"phase 10 poa_add edges A={A} P={P} S={S} N={bs.padded_nodes}"
              f"{' with the MSA' * msa}: every lockstep launch vs its plain "
              f"version, max diff {probed['err']}; the largest clique "
              f"{nalig}, the most preds {npred}, statuses "
              f"{sorted(set(st.status.tolist()))}")
        check(probed["err"] == 0,
              f"B6 disagrees with its plain version at A={A} P={P}")
        check((A < 31 or nalig >= 31) and (A < 63 or nalig > 32)
              and npred >= min(P, 4), f"B6 edge batch A={A} P={P} filled "
              f"too little: clique {nalig}, preds {npred}")
    check({0, 23, 24} <= statuses, f"B6 edges: statuses {statuses}")
    return err


#: scores whose graph-NW cells pass the 24 bits of a 4-byte plane word
#: at the smoke's small shapes (phase 10's N + L + 1 = 169 too): (match,
#: mismatch, gap)
WIDE_SCORES = (40_000, -30_000, -40_000)
#: B10's plans held in phase 10: (variant, ring depth)
WINDOW_PLANS = (("warp", 8), ("block", 8), ("warp", 2), ("block", 0))


@contextlib.contextmanager
def window_forced(variant: str, ring: int):
    """Inside the block ops.poa_window.window_plan gives launches of any
    window count the ``variant`` asked for (BLOCK_WINDOWS 0: warp where a
    row fits; a million: block) and a ring of at most ``ring`` rows."""
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    saved = poa_window.BLOCK_WINDOWS, poa_window.RING_ROWS
    poa_window.BLOCK_WINDOWS = 0 if variant == "warp" else 1 << 20
    poa_window.RING_ROWS = ring
    try:
        yield
    finally:
        poa_window.BLOCK_WINDOWS, poa_window.RING_ROWS = saved


#: B5 edge batches: (BatchSize keywords, banded, variant, ring depth,
#: scores); a warp a window and a block a window (rows up to 512 columns,
#: and wider), each with the 8-row ring, a 2-row ring or none; 72 pred
#: slots (past the 64 a warp carries in flight); 8-byte plane words (scores
#: whose cells pass 24 bits), full and banded
NWTB_VARIANTS = (
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "warp",
     8, None),
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "warp", 0,
     None),
    (dict(max_sequence_size=100, max_sequences_per_poa=5, band_width=24),
     True, "warp", 2, None),
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "block",
     8, None),
    (dict(max_sequence_size=100, max_sequences_per_poa=5, band_width=24),
     True, "block", 0, None),
    (dict(max_sequence_size=600, max_sequences_per_poa=4), False, "block",
     8, None),
    (dict(max_sequence_size=600, max_sequences_per_poa=4), False, "block",
     0, None),
    (dict(max_sequence_size=100, max_sequences_per_poa=5,
          max_pred_per_node=72), False, "warp", 8, None),
    (dict(max_sequence_size=100, max_sequences_per_poa=5), False, "warp", 8,
     WIDE_SCORES),
    (dict(max_sequence_size=100, max_sequences_per_poa=5, band_width=24),
     True, "block", 8, WIDE_SCORES),
)


@contextlib.contextmanager
def nwtb_forced(variant: str, ring: int):
    """Inside the block ops.poa_nwtb.nwtb_plan gives launches of any window
    count the ``variant`` asked for (BLOCK_WINDOWS 0: warp where a row
    fits; a million: block) and a ring of at most ``ring`` rows
    (RING_ROWS)."""
    from claragenomicsanalysis_tpu_torch.ops import poa_nwtb
    saved = poa_nwtb.BLOCK_WINDOWS, poa_nwtb.RING_ROWS
    poa_nwtb.BLOCK_WINDOWS = 0 if variant == "warp" else 1 << 20
    poa_nwtb.RING_ROWS = ring
    try:
        yield
    finally:
        poa_nwtb.BLOCK_WINDOWS, poa_nwtb.RING_ROWS = saved


def phase_nwtb_variants() -> int:
    """Phase 10b: B5's variants (ops.poa_nwtb.nwtb_plan, steered by
    nwtb_forced) against its plain version at every launch of a lockstep
    run, and with them the other lockstep kernels.  -> the largest
    difference."""
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.ops import poa_nwtb
    err = 0
    for i, (kw, banded, variant, ring, sc) in enumerate(NWTB_VARIANTS):
        bs = BatchSize(**kw)
        scores = PoaScores(*sc) if sc else PoaScores()
        S, L = bs.max_sequences_per_poa, bs.padded_seq
        N, P = bs.padded_nodes, bs.max_pred_per_node
        bw = bs.band_width if banded else 0
        _, _, arrays = poa_window_arrays(24, bs.max_sequence_size - 10, S,
                                         max(3, bs.max_sequence_size // 30),
                                         L, SEED + 40 + i)
        word = poa_nwtb.nwtb_word_bytes(N, L, scores)
        with nwtb_forced(variant, ring):
            plan = poa_nwtb.nwtb_plan(24, N, P, L, bw, word)
            check(plan[0] == variant and plan[2] == ring,
                  f"B5 edge batch {i} got the plan {plan}")
            _, probed = run_poa_arrays(bs, banded, arrays, True,
                                       scores=scores)
        err = max(err, probed["err"])
        print(f"phase 10b poa_nwtb variant {plan} (N={N} L={L} P={P}"
              f"{', banded' if banded else ''}, {word}-byte words): every "
              f"lockstep launch vs its plain version, max diff "
              f"{probed['err']}")
        check(probed["err"] == 0, f"B5 variant {plan} disagrees with its "
              f"plain version")
    return err


def c10_msa_state(N: int = 58_120, W: int = 2, S: int = 3, L: int = 64,
                  nodes: int = 300):
    """A synthetic final graph of W windows at N nodes a window (P = A =
    4), ``nodes`` of them active: a backbone chain with aligned pairs every
    37 nodes, and S paths of L nodes each, on the card -> (state, order).
    C10's threshold is N, not node_count, so the plain version stays
    cheap."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops.poa_state import PoaState
    rng = np.random.default_rng(SEED + 90)
    P = A = 4
    i32 = np.int32
    base = np.full((W, N), -1, i32)
    npred, nalig = np.zeros((W, N), i32), np.zeros((W, N), i32)
    pred, alig = np.full((W, N, P), -1, i32), np.full((W, N, A), -1, i32)
    paths = np.full((W, S, L), -1, i32)
    base[:, :nodes] = rng.integers(0, 4, (W, nodes))
    npred[:, 1:nodes] = 1
    pred[:, 1:nodes, 0] = np.arange(nodes - 1)
    for w in range(W):
        for u in range(10 + w, nodes - 2, 37):    # u and u + 1 aligned
            nalig[w, u] = nalig[w, u + 1] = 1
            alig[w, u, 0], alig[w, u + 1, 0] = u + 1, u
            pred[w, u + 1, 0] = u - 1
        for si in range(S):
            start = int(rng.integers(0, nodes - L))
            paths[w, si] = np.arange(start, start + L)

    def t(a):
        return torch.from_numpy(a).cuda()

    state = PoaState(base=t(base), cov=t(np.ones((W, N), i32)),
                     npred=t(npred), pred=t(pred),
                     predw=t(np.ones((W, N, P), i32)),
                     nsucc=t(np.zeros((W, N), i32)), nalig=t(nalig),
                     alig=t(alig), node_count=t(np.full(W, nodes, i32)),
                     status=t(np.zeros(W, i32)), paths=t(paths))
    return state, t(np.tile(np.arange(N, dtype=i32), (W, 1)))


def phase_c8_poa(sm_mhz: float) -> dict:
    """Phase 18 (C8, C10; POA): windows at ``cli poa``'s sizes (BatchSize
    from the longest sequence S: N = 3S, P = 4, MC = 2S) through the
    lockstep route: two windows of three 2,048-base sequences with the MSA,
    every launch of every kernel against its plain version (B8 one window
    a block, B5 a block a window), then two windows of three 9,000-base
    sequences (B7 and B8 on device memory, B5 past the first design's L =
    8,191 with a 4-row ring), each kernel at its largest launch against
    its plain version; times and bounds at both.  Then C10: B9 launched
    directly at N = 58,120 (cli poa's sizing for 19,371-base sequences,
    past what its first design held in shared memory) on a synthetic
    graph, against its plain version.  -> kernel name -> a list of variant
    figures."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import BatchSize
    from claragenomicsanalysis_tpu_torch.ops import (poa_consensus, poa_msa,
                                                     poa_nwtb, poa_topsort)
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)
    variants = {}
    for blen, compare in ((2_048, True), (9_000, False)):
        bs = BatchSize(max_sequence_size=blen, max_sequences_per_poa=3)
        N, L, P = bs.padded_nodes, bs.padded_seq, bs.max_pred_per_node
        MC, A = bs.max_consensus_size, bs.max_aligned_per_node
        plan = {"poa_topsort": poa_topsort.topsort_plan(N),
                "poa_nwtb": poa_nwtb.nwtb_plan(2, N, P, L, 0),
                "poa_consensus": poa_consensus.consensus_plan(2, N, P, MC)}
        if compare:
            plan["poa_msa"] = poa_msa.msa_plan(2, N, P, A, 3, L)
        _, _, arrays = poa_window_arrays(2, blen - 8, 3, blen // 40, L,
                                         SEED + 50 + blen)
        t0 = time.perf_counter()
        with kernel_times() as kt, stage_times() as st:
            out, probed = run_poa_arrays(bs, False, arrays, compare,
                                         msa=compare)
            launches = read_launches(st, POA_KERNELS)
            dev_ms = kt.ms()
        status = out[5].tolist()
        print(f"phase 18 C8 poa: 2 windows of 3 x {blen - 8} bases at cli "
              f"poa's BatchSize (N={N} L={L} P={P} MC={MC})"
              f"{', with the MSA' * compare}, plans {plan}: "
              f"{time.perf_counter() - t0:.1f} s, launches "
              f"{launches}, statuses {status}, consensus lengths "
              f"{out[2].tolist()}" + (f"; every launch vs its plain version, "
                                      f"max diff {probed['err']}"
                                      if compare else ""))
        check(status == [0, 0], f"C8 poa {blen}: statuses {status}")
        check(probed["err"] == 0, f"C8 poa {blen}: a kernel disagrees with "
              f"its plain version")
        check(all(abs(int(n) - (blen - 8)) < blen // 10
                  for n in out[2].tolist()), "C8 poa: consensus lengths")
        per = replay_poa_kernels(f"phase 18 C8 poa {blen}:", kt, launches,
                                 dev_ms, bs, sm_mhz)
        kt.largest.clear()
        for k, v in per.items():
            variants.setdefault(k, []).append(dict(
                v, variant=f"C8 cli poa, {blen - 8}-base sequences: "
                           f"{plan.get(k, 'as before')}"))

    state, order = c10_msa_state()
    W, N, P = state.pred.shape
    plan = poa_msa.msa_plan(W, N, P, 4, *state.paths.shape[1:])
    ms, got = cuda_ms(lambda: poa_msa.msa(state, order), 5)
    ms_p, want = cuda_ms(lambda: poa_msa.msa_torch(state, order), 1)
    err = maxdiff(got, want)
    ops, nbytes, what = work_msa((state, order), got)
    b = bound(ops, nbytes, sm_mhz)
    shape = f"W={W} N={N} P={P} A=4 S=3 L=64, 300 active nodes"
    print(f"phase 18 C10 poa_msa: launched directly at {shape} (cli poa's "
          f"N for 19,371-base sequences), plan {plan}: kernel {ms:.3f} ms vs "
          f"plain {ms_p:.1f} ms, max diff {err}, {int(got[1].min())}-"
          f"{int(got[1].max())} columns; bound {what}, {ops} int32 ops, "
          f"{nbytes} B -> {b[0]:.4f} ms ({b[1]})")
    check(plan == ("warp-device", 4), f"C10: B9's plan {plan} at N={N}")
    check(err == 0 and int(got[1].min()) > 0,
          "C10: B9 disagrees with its plain version at N = 58,120")
    variants.setdefault("poa_msa", []).append(dict(
        variant=f"C10 direct launch: {'/'.join(map(str, plan))}",
        shape=shape, ms=ms, plain_ms=ms_p, bound=b, err=err))
    torch.cuda.synchronize()
    return variants


def phase_poa_cli():
    """Phase 11: cli poa on the card against the consensus golden, --msa
    against the MSA golden and the CPU, --banded on the card and the CPU,
    byte for byte."""
    from claragenomicsanalysis_tpu_torch import cli
    data = os.path.join(ROOT, "data")
    golden = {}
    for name in ("consensus", "msa"):
        with open(os.path.join(data, "golden", f"sample_{name}.txt")) as f:
            golden[name] = f.read()
    outs = {}
    for extra in ([], ["--msa"], ["--banded"]):
        for device in ("cuda", "cpu") if extra else ("cuda",):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["poa", f"{data}/sample-windows.txt", "--device",
                               device] + extra)
            check(rc == 0, f"cli poa {extra} --device {device} failed")
            outs[("".join(extra), device)] = buf.getvalue()
    same = outs[("", "cuda")] == golden["consensus"]
    msa = outs[("--msa", "cuda")] == golden["msa"]
    msa_cpu = outs[("--msa", "cuda")] == outs[("--msa", "cpu")]
    banded = outs[("--banded", "cuda")] == outs[("--banded", "cpu")]
    word = {True: "identical", False: "DIFFERENT"}
    print(f"phase 11 golden: poa --device cuda vs data/golden/"
          f"sample_consensus.txt: {word[same]} "
          f"({len(golden['consensus'].splitlines())} lines); poa --msa "
          f"--device cuda vs data/golden/sample_msa.txt: {word[msa]} "
          f"({len(golden['msa'].splitlines())} lines), vs --device cpu: "
          f"{word[msa_cpu]}; poa --banded cuda vs cpu: {word[banded]}")
    check(same, "poa output differs from data/golden/sample_consensus.txt")
    check(msa, "poa --msa output differs from data/golden/sample_msa.txt")
    check(msa_cpu, "poa --msa differs between cuda and cpu")
    check(banded, "poa --banded differs between cuda and cpu")


def edit_distances(pairs) -> "np.ndarray":
    """Edit distances of (a, b) pairs through the port's ukkonen aligner on
    the card."""
    import numpy as np
    _, res, _ = run_aligner(pairs, "ukkonen")
    return np.array([r.edit_distance for r in res])


def run_poa_batch(bs, windows, banded: bool, msa: bool, kernel: str,
                  device: str = "cuda"):
    """The windows through create_batch(...) on ``device``: generate_poa,
    get_consensus and, with ``msa``, get_msa, timed by the host clock ending
    in a sync, launches counted from zero and every kernel timed by its
    events.  -> dict(cons, covs, stats, msas, wall, launches, kt, peak)."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.status import OutputType
    from claragenomicsanalysis_tpu_torch.models import poa
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)
    mask = OutputType.CONSENSUS | (OutputType.MSA if msa else 0)
    batch = poa.create_batch(bs, output_mask=mask, max_poas=len(windows),
                             banded_alignment=banded, device=device,
                             kernel=kernel)
    for w in windows:
        batch.add_poa_group(w)
    settle_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kernel_times() as kt, stage_times() as st:
        batch.generate_poa()
        cons, covs, stats = batch.get_consensus()
        msas = batch.get_msa()[0] if msa else None
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(st, POA_KERNELS)
    check(kt.count() == {k: v for k, v in launches.items() if v},
          f"timed launches {kt.count()} != counted {launches}")
    return dict(cons=cons, covs=covs, stats=stats, msas=msas, wall=wall,
                launches=launches, kt=kt,
                peak=torch.cuda.max_memory_allocated())


def check_msa_rows(tag: str, windows, msas, stats) -> int:
    """Every SUCCESS window's rows have one length, and each row with its
    gaps removed is its sequence, or holds no base its sequence lacks: where
    a clique got its column before a pred of one member had one, that pred
    takes the same column or a later one, so two positions of a sequence can
    share a column (the later one shows) or stand out of order (the JAX
    package's rule, kept).  -> rows written."""
    import collections
    from claragenomicsanalysis_tpu_torch.core.status import StatusType
    n_rows = n_whole = n_cols = n_short = 0
    for w, m, st in zip(windows, msas, stats):
        if st != StatusType.SUCCESS:
            check(m == [], f"{tag}: a failed window shows rows")
            continue
        check(len(m) == len(w) and len({len(r) for r in m}) == 1,
              f"{tag}: a window's rows differ in length")
        n_cols += len(m[0])
        for row, seq in zip(m, w):
            bases = row.replace("-", "")
            n_rows += 1
            n_whole += bases == seq
            n_short += len(bases) < len(seq)
            check(not collections.Counter(bases) - collections.Counter(seq),
                  f"{tag}: a row holds a base its sequence lacks")
    print(f"{tag} MSA rows: {n_rows} rows of equal length within their "
          f"window ({n_cols} columns in all); with the gaps removed "
          f"{n_whole} are their input sequence; of the other "
          f"{n_rows - n_whole}, {n_short} lost bases to a shared column and "
          f"{n_rows - n_whole - n_short} hold theirs out of order")
    check(n_whole > n_rows // 2, f"{tag}: most rows lose bases")
    return n_rows


def check_graphs(tag: str, bs, banded: bool, windows, arrays, sub) -> None:
    """get_graphs() on the windows ``sub`` against the final graph state of
    the lockstep kernels on the same windows: the node count, every label
    and every edge weight."""
    from claragenomicsanalysis_tpu_torch.models import poa
    batch = poa.create_batch(bs, max_poas=len(sub), banded_alignment=banded,
                             device="cuda")
    for i in sub:
        batch.add_poa_group(windows[i])
    graphs = batch.get_graphs()
    out, _ = run_poa_arrays(bs, banded, [a[sub] for a in arrays], False)
    base, cov, npred, pred, predw, nc, status = (
        t.cpu().numpy() for t in (out[6].base, out[6].cov, out[6].npred,
                                  out[6].pred, out[6].predw,
                                  out[6].node_count, out[6].status))
    n_nodes = n_edges = n_none = 0
    for k, g in enumerate(graphs):
        if status[k] != 0:
            check(g is None, f"{tag}: a failed window exports a graph")
            n_none += 1
            continue
        dot = g.serialize_to_dot()
        check(g.nodes() == list(range(int(nc[k]))),
              f"{tag}: graph {k} has the wrong nodes")
        for u in range(int(nc[k])):
            label = f'{"ACGT"[base[k, u]]}:{int(cov[k, u])}'
            check(f'  {u} [label="{label}"];' in dot,
                  f"{tag}: graph {k} node {u} label")
            for p in range(int(npred[k, u])):
                check(g.edge_weight(int(pred[k, u, p]), u)
                      == int(predw[k, u, p]), f"{tag}: graph {k} edge weight")
                n_edges += 1
        n_nodes += int(nc[k])
    print(f"{tag} get_graphs: {len(sub)} windows, {n_nodes} nodes and "
          f"{n_edges} edges equal the final state's node counts, labels "
          f"and predw; {n_none} failed windows export None")


def poa_plan(k: str, args) -> str:
    """The plan a launch of POA kernel ``k`` on ``args`` takes."""
    from claragenomicsanalysis_tpu_torch.ops import (poa_consensus, poa_msa,
                                                     poa_nwtb, poa_topsort)
    if k == "poa_topsort":
        return "/".join(map(str, poa_topsort.topsort_plan(args[2].shape[1])))
    if k == "poa_nwtb":
        seq, pred, sc, bw = args[0], args[6], args[10], args[11]
        W, L = seq.shape
        N, P = pred.shape[1:]
        return "/".join(map(str, poa_nwtb.nwtb_plan(
            W, N, P, L, bw, poa_nwtb.nwtb_word_bytes(N, L, sc))))
    if k == "poa_add":
        return "a warp a window"    # B6 has one
    if k == "poa_consensus":
        W, N, P = args[1].shape
        return "/".join(map(str, poa_consensus.consensus_plan(W, N, P,
                                                              args[7])))
    state, order = args
    W, N, P = state.pred.shape
    return "/".join(map(str, poa_msa.msa_plan(
        W, N, P, state.alig.shape[2], *state.paths.shape[1:])))


#: the figures of a kernel replayed at a path's largest launch that the
#: kernels line keeps (path_kernels)
REPLAY_FIGURES = ("shape", "plan", "ms", "plain_ms", "bound", "err")

#: where each lockstep kernel's arguments hold the window's pred table
POA_PRED_ARG = {"poa_topsort": lambda a: a[2], "poa_nwtb": lambda a: a[6],
                "poa_add": lambda a: a[0].pred,
                "poa_consensus": lambda a: a[1],
                "poa_msa": lambda a: a[0].pred}


def replay_poa_kernel(tag: str, k: str, args, sm_mhz: float,
                      shape: str | None = None) -> dict:
    """Lockstep kernel ``k`` on ``args`` (a launch's inputs) against its
    plain version, exactly, with its time (mean of 5 launches), the plain
    version's (one call) and its bound; ``shape`` names the launch (by
    default its windows, nodes and pred slots).  -> figures."""
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    name, plain, work = POA_STEPS[k]
    kernel, plain = getattr(poa_window, name), getattr(poa_window, plain)
    ms, out_k = cuda_ms(lambda: kernel(*args), 5)
    ms_p, out_p = cuda_ms(lambda: plain(*args), 1)
    err = maxdiff(out_k, out_p)
    ops, nbytes, what = work(args, out_k)
    b = bound(ops, nbytes, sm_mhz)
    if shape is None:
        W, N, P = POA_PRED_ARG[k](args).shape
        shape = f"W={W} N={N} P={P}"
    plan = poa_plan(k, args)
    print(f"{tag} {k} ({plan}) replayed at its largest launch ({shape}): "
          f"kernel {ms:.3f} ms vs plain {ms_p:.1f} ms, max diff {err}; bound "
          f"{what}, {ops} int32 ops, {nbytes} B -> {b[0]:.4f} ms ({b[1]})")
    check(err == 0, f"{tag}: {k} disagrees with its plain version at its "
          f"largest launch")
    return {"shape": shape, "plan": plan, "ms": ms, "plain_ms": ms_p,
            "bound": b, "err": err}


def replay_poa_kernels(tag: str, kt, launches: dict, dev_ms: dict, bs,
                       sm_mhz: float) -> dict:
    """Each lockstep kernel at its largest launch of a run against its
    plain version (replay_poa_kernel).  -> kernel name -> figures."""
    N, L = bs.padded_nodes, bs.padded_seq
    per = {}
    for k in POA_STEPS:
        if not launches[k]:
            continue
        args = kt.largest[k]
        W = POA_PRED_ARG[k](args).shape[0]
        each = [s.elapsed_time(e) for s, e in kt.events[k]]
        print(f"{tag} {k}: {launches[k]} launches, {dev_ms[k]:.3f} ms in the "
              f"run (largest launch {max(each):.3f} ms by its events)")
        per[k] = replay_poa_kernel(
            tag, k, args, sm_mhz,
            f"W={W} N={N} L={L} P={bs.max_pred_per_node}") | {
            "launches": launches[k], "run_ms": dev_ms[k]}
    return per


def phase_poa_main(tag: str, cfg: dict, n: int, blen: int, edits: int,
                   banded: bool, sm_mhz: float, msa: bool = False):
    """Phases 12, 13 and 14: a POA main path through create_batch(...,
    device="cuda"), add_poa_group, generate_poa, get_consensus and, with
    ``msa``, get_msa, with its checks, launch counts, kernel times and
    bounds.  -> (per-kernel figures, the run and its data, for phase 15)."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import BatchSize
    from claragenomicsanalysis_tpu_torch.core.status import StatusType
    from claragenomicsanalysis_tpu_torch.models import poa
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    bs = BatchSize(**cfg)
    S, N, L = bs.max_sequences_per_poa, bs.padded_nodes, bs.padded_seq
    t0 = time.perf_counter()
    backbones, windows, arrays = poa_window_arrays(n, blen, S, edits, L,
                                                   SEED + 20 + S + msa)
    t_data = time.perf_counter() - t0
    run = run_poa_batch(bs, windows, banded, msa, "lockstep")
    cons, covs, stats, msas = (run[k] for k in ("cons", "covs", "stats",
                                                "msas"))
    wall, launches, kt = run["wall"], run["launches"], run["kt"]
    chunks = poa.launch_chunks(n, bs, msa)
    want = {"poa_topsort": len(chunks) * S, "poa_nwtb": len(chunks) * (S - 1),
            "poa_add": len(chunks) * (S - 1), "poa_consensus": len(chunks),
            "poa_msa": len(chunks) * msa, "poa_window": 0}
    check(launches == want, f"{tag}: launches {launches} != {want} "
          f"({len(chunks)} launches of windows)")
    dev_ms = kt.ms()
    busy = sum(dev_ms.values())
    ok = np.array([s == StatusType.SUCCESS for s in stats])
    n_ok = int(ok.sum())

    # the same windows through the kernels in one launch each: their real
    # graph-NW cells, and the outputs must equal the batch's
    out, probed = run_poa_arrays(bs, banded, arrays, False, msa)
    codes, _, length, rows, n_cols, status = (t.cpu().numpy()
                                              for t in out[:6])
    cells = probed["cells"]
    same = all(st == StatusType(int(status[i])) for i, st in enumerate(stats))
    same &= all(c == "".join("ACGT"[x] if x >= 0 else "N"
                             for x in codes[i, :int(length[i])].tolist())
                for i, c in enumerate(cons) if ok[i])
    if msa:
        gap = np.frombuffer(b"ACGT-", dtype=np.uint8)
        chars = gap[np.where(rows >= 0, np.clip(rows, 0, 3), 4)]
        same &= all(m == [chars[i, si, :n_cols[i]].tobytes().decode()
                          for si in range(len(windows[i]))]
                    for i, m in enumerate(msas) if ok[i])
    padded = n * (S - 1) * N * (L + 1)
    bases = sum(len(c) for c in cons)
    what = "get_consensus + get_msa" if msa else "get_consensus"
    print(f"{tag} main path ({what}): {n} windows of {S} x {blen}-base "
          f"pileups ({edits} edits each){', banded' if banded else ''}, "
          f"BatchSize({', '.join(f'{k}={v}' for k, v in cfg.items())}), "
          f"N={N} L={L}; data made in {t_data:.1f} s")
    print(f"{tag} end to end: {wall:.3f} s = {n / wall:.1f} windows/s = "
          f"{bases / wall / 1e6:.4f} M consensus bases/s; graph-NW "
          f"{cells / wall / 1e9:.4f} G real cells/s ({cells} = alive "
          f"node_count x (slen + 1) per add), {padded / wall / 1e9:.4f} G "
          f"padded cells/s ({padded} = N x (L + 1) per add); kernel share "
          f"{busy / (wall * 1e3):.4f} ({busy:.2f} ms of {wall * 1e3:.1f} ms)"
          f"; {len(chunks)} launches of windows ({[len(c) for c in chunks]}"
          f"); max_memory_allocated={run['peak']} B")
    failed = sorted({s.name for s in stats if s != StatusType.SUCCESS})
    print(f"{tag} checks: {n_ok}/{n} SUCCESS{f' (the others {failed})' * bool(failed)}"
          f"; the kernels driven in one launch of all windows give the same "
          f"consensus{', MSA' * msa} and statuses: {same}")
    if msa:
        # 4 pred slots a node: a few windows overflow them and say so
        check(n_ok >= MIN_OK_MSA * n and set(failed) <= {
            "EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE",
            "NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE"},
            f"{tag}: only {n_ok} of {n} windows SUCCESS ({failed})")
    else:
        check(n_ok == n, f"{tag}: only {n_ok} of {n} windows SUCCESS")
    check(same, f"{tag}: one launch of all windows differs from the batch")
    if msa:
        n_rows = check_msa_rows(tag, windows, msas, stats)
        print(f"{tag} MSA rate: {n_rows / wall:.1f} MSA rows/s")

    # the plain path (CPU) on a subset
    sub = list(range(0, n, n // N_POA_PLAIN))[:N_POA_PLAIN]
    t0 = time.perf_counter()
    cpu = run_poa_batch(bs, [windows[i] for i in sub], banded, msa,
                        "lockstep", "cpu")
    t_cpu = time.perf_counter() - t0
    plain_same = (cpu["cons"] == [cons[i] for i in sub]
                  and cpu["covs"] == [covs[i] for i in sub]
                  and cpu["stats"] == [stats[i] for i in sub]
                  and (not msa or cpu["msas"] == [msas[i] for i in sub]))
    print(f"{tag} plain path: {len(sub)} windows through Batch(device="
          f'"cpu") in {t_cpu:.1f} s: consensus, coverage{", MSA" * msa} and '
          f"statuses equal the card's: {plain_same}")
    check(plain_same, f"{tag}: the plain path differs from the card's")
    if msa:
        check_graphs(tag, bs, banded, windows, arrays, sub)

    # accuracy: edit distance to the backbone, consensus vs one support
    good = np.flatnonzero(ok)
    d_cons = edit_distances([(cons[i], backbones[i]) for i in good])
    d_sup = edit_distances([(windows[i][0], backbones[i]) for i in good])
    print(f"{tag} accuracy: median edit distance to the backbone "
          f"{float(np.median(d_cons)):.1f} for the consensus vs "
          f"{float(np.median(d_sup)):.1f} for a support (mean "
          f"{float(d_cons.mean()):.3f} vs {float(d_sup.mean()):.3f})")
    check(np.median(d_cons) < np.median(d_sup),
          f"{tag}: the consensus is not closer to the backbone than a "
          f"support")

    per = replay_poa_kernels(tag, kt, launches, dev_ms, bs, sm_mhz)
    kt.largest.clear()      # the kept inputs of the largest launches
    return per, dict(run, bs=bs, windows=windows, banded=banded, msa=msa,
                     cfg=cfg)


def phase_poa_window(tag: str, ref: dict, sm_mhz: float) -> dict:
    """Phase 15: the windows of an earlier phase (``ref``: its run through
    the lockstep route and its data) through create_batch(...,
    kernel="window"): the same outputs; the two routes' walls in turns on
    the same data; B10 at its largest launch against its plain version,
    with its time and bound."""
    from claragenomicsanalysis_tpu_torch.models import poa
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    bs, windows, banded, msa = (ref[k] for k in ("bs", "windows", "banded",
                                                 "msa"))
    n = len(windows)
    runs = []
    for i, kernel in enumerate(("lockstep", "window", "window", "lockstep")):
        r = run_poa_batch(bs, windows, banded, msa, kernel)
        if i != 1:      # the kept inputs of the largest launches: let go
            r["kt"].largest.clear()
        runs.append((kernel, r))
    run = runs[1][1]
    chunks = poa.launch_chunks(n, bs, msa, kernel="window")
    want = dict.fromkeys(POA_KERNELS, 0) | {"poa_window": len(chunks)}
    check(run["launches"] == want,
          f"{tag}: launches {run['launches']} != {want}")
    same = all(r[k] == ref[k] for _, r in runs
               for k in ("cons", "covs", "stats", "msas"))
    dev_ms = run["kt"].ms()["poa_window"]
    each = [s.elapsed_time(e) for s, e in run["kt"].events["poa_window"]]
    bw = bs.band_width if banded else 0
    plan = poa_window.window_plan(len(chunks[0]), bs, bw)
    walls = ", ".join(f"{k} {r['wall'] * 1e3:.1f} ms = {n / r['wall']:.1f} "
                      f"windows/s" for k, r in runs)
    what = "get_consensus + get_msa" if msa else "get_consensus"
    print(f"{tag} kernel=\"window\" ({what}): {n} windows, BatchSize("
          f"{', '.join(f'{k}={v}' for k, v in ref['cfg'].items())}), "
          f"{len(chunks)} launches of windows ({[len(c) for c in chunks]}), "
          f"plan {plan}, {poa_window.window_smem_bytes(bs, bw)} B of shared "
          f"memory and {poa_window.window_scratch_bytes(bs)} B of device "
          f"scratch a window; "
          f"consensus, coverage, statuses{', MSA rows' * msa} equal the "
          f"lockstep route's: {same}")
    print(f"{tag} walls in turns on the same windows: {walls}; B10 "
          f"{dev_ms:.2f} ms in its run ({[round(x, 3) for x in each]} ms a "
          f"launch), kernel share {dev_ms / (run['wall'] * 1e3):.4f}; "
          f"max_memory_allocated={run['peak']} B")
    check(same, f"{tag}: the window route differs from the lockstep route")

    args = run["kt"].largest["poa_window"]
    fig, out_p = replay_window_kernel(tag, args, bs, banded, msa, sm_mhz)
    ms_p, b, shape, W = (fig["plain_ms"], fig["bound"], fig["shape"],
                         args[0].shape[0])
    # and in the plan this launch does not take
    mine = poa_window.window_plan(W, bs, bw)[0]
    other = "block" if mine == "warp" else "warp"
    with window_forced(other, poa_window.RING_ROWS):
        ms_o, out_o = cuda_ms(lambda: poa_window.poa_window(*args), 5)
    err_o = maxdiff(out_o, out_p)
    print(f"{tag} poa_window: the same launch as a {other} a window "
          f"(forced; the plan takes a {mine}): {ms_o:.3f} ms, max diff "
          f"{err_o} vs the plain version")
    check(err_o == 0, f"{tag}: poa_window as a {other} a window disagrees "
          f"with its plain version")
    variant = {"variant": f"{tag}: a {other} a window (forced)",
               "shape": shape, "ms": ms_o, "plain_ms": ms_p, "bound": b,
               "err": err_o}
    return {"poa_window": fig | {"launches": run["launches"]["poa_window"],
                                 "run_ms": dev_ms}}, variant


def replay_window_kernel(tag: str, args, bs, banded: bool, msa: bool,
                         sm_mhz: float) -> dict:
    """B10 on ``args`` (a launch's inputs) against its plain version,
    exactly, with its time (mean of 5 launches), the plain version's (one
    call) and its bound: the operations of every step of the lockstep loop
    on these windows, the bytes of the inputs' real bases and of the
    outputs only.  -> (figures, the plain version's outputs)."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    S = bs.max_sequences_per_poa
    ms, out_k = cuda_ms(lambda: poa_window.poa_window(*args), 5)
    ms_p, out_p = cuda_ms(lambda: poa_window.poa_window_torch(*args), 1)
    err = maxdiff(out_k, out_p)
    seqs, weights, lens, n_seqs = args[:4]
    W = seqs.shape[0]
    _, probed = run_poa_arrays(bs, banded, args[:4], False, msa, True)
    real = int(torch.where(torch.arange(S, device=lens.device)[None, :]
                           < n_seqs[:, None], lens, 0).sum())
    nbytes = 8 * real + 4 * W * S + 4 * W + sum(4 * t.numel() for t in out_k)
    b = bound(probed["ops"], nbytes, sm_mhz)
    shape = (f"W={W} N={bs.padded_nodes} L={bs.padded_seq} "
             f"P={bs.max_pred_per_node} S={S}{' msa' * msa}")
    bw = bs.band_width if banded else 0
    plan = "/".join(map(str, poa_window.window_plan(W, bs, bw)))
    print(f"{tag} poa_window ({plan}): replayed at the largest launch "
          f"({shape}): kernel {ms:.3f} ms vs plain {ms_p:.1f} ms, max diff "
          f"{err}; bound {probed['ops']} int32 ops (every step of the "
          f"lockstep loop), {nbytes} B (inputs and outputs) -> {b[0]:.4f} ms "
          f"({b[1]})")
    check(err == 0, f"{tag}: poa_window disagrees with its plain version at "
          f"its largest launch")
    return {"shape": shape, "plan": plan, "ms": ms, "plain_ms": ms_p,
            "bound": b, "err": err}, out_p


def phase_row(pairs, ukk, myers_results, sm_mhz: float) -> dict:
    """Phase 16: the row route, ``create_aligner(..., kernel="row")``, on
    phase 5's pairs through ``ukkonen``: the same results pair for pair,
    launches of B3 and B2's row decode only, its wall and kernel share
    beside phase 5's, each kernel against its plain version at its largest
    launch; then the other three algorithms through the row route on phase
    7's subset, equal to the diag route's results there."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch import create_aligner
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)
    n = len(pairs)
    aligner = create_aligner(max(len(a) for a, _ in pairs),
                             max(len(b) for _, b in pairs), n,
                             band_radius=64, device="cuda", kernel="row")
    for a, b in pairs:
        aligner.add_alignment(a, b)
    settle_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kernel_times() as kt, stage_times() as st:
        aligner.align_all()
        results = aligner.get_alignments()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(st)
    peak = torch.cuda.max_memory_allocated()
    plan = aligner._plan(np.array([len(a) for a, _ in pairs]),
                         np.array([len(b) for _, b in pairs]))
    bases = sum(len(a) + len(b) for a, b in pairs)
    print(f"phase 16 row route (ukkonen, kernel=\"row\"): {n} alignments "
          f"in {wall:.3f} s = {n / wall:.1f} alignments/s = "
          f"{bases / wall / 1e6:.2f} Mbp/s end to end (phase 5, the diag "
          f"route: {ukk['wall']:.3f} s = {n / ukk['wall']:.1f} alignments/s)"
          f"; launches={launches} chunks={len(plan)} "
          f"max_memory_allocated={peak} B")
    check(launches == {"nw_diag": 0, "tb_decode": 0, "nw_row": len(plan),
                       "tb_decode_row": len(plan), "myers": 0, "cigar": 0},
          f"launches {launches} != one of B3 and B2-row per chunk "
          f"({len(plan)} chunks) and none of the diag kernels")
    check(kt.count() == {"nw_row": len(plan), "tb_decode_row": len(plan)},
          f"timed launches {kt.count()}")
    dev_ms = kt.ms()
    busy = sum(dev_ms.values())
    diag_ms = sum(v["run_ms"] for v in ukk["kernels"].values())
    print(f"phase 16 breakdown (CUDA events inside the run): nw_row "
          f"{dev_ms['nw_row']:.2f} ms + tb_decode_row "
          f"{dev_ms['tb_decode_row']:.2f} ms = {busy:.2f} ms of "
          f"{wall * 1e3:.1f} ms end to end (kernel share "
          f"{busy / (wall * 1e3):.4f}; phase 5's kernels {diag_ms:.2f} ms, "
          f"share {diag_ms / (ukk['wall'] * 1e3):.4f})")
    same = [(r.status, r.edit_distance, r.path)
            == (u.status, u.edit_distance, u.path)
            for r, u in zip(results, ukk["results"])]
    print(f"phase 16 checks: paths, distances and statuses equal phase 5's "
          f"on {sum(same)} of {n} pairs")
    check(all(same) and len(results) == n,
          "the row route differs from the diag route (phase 5)")

    # each kernel against its plain version at the largest launch
    q, qlen, t, tlen, r = kt.largest["nw_row"]
    per = time_banded(q, qlen, t, tlen, r, sm_mhz,
                      "phase 16 largest launch:", "row")
    kt.largest.clear()
    for k, n_launch in launches.items():
        per.setdefault(k, {}).update(launches=n_launch,
                                     run_ms=dev_ms.get(k, 0.0))

    sub = pairs[:N_SUBSET]
    for algorithm in ("myers", "hirschberg-myers", "banded-escalate"):
        with stage_times() as st:
            _, res, w = run_aligner(sub, algorithm, kernel="row")
        ran = read_launches(st)
        same = all((r.status, r.path, r.edit_distance)
                   == (m.status, m.path, m.edit_distance)
                   for r, m in zip(res, myers_results))
        print(f"phase 16 {algorithm} (kernel=\"row\") on {len(sub)} of "
              f"these pairs: {w:.3f} s, routed to Hirschberg "
              f"{read_hirschberg(st)[0]}, launches={ran}; paths, distances "
              f"and statuses equal the diag route's: {same}")
        check(same, f"{algorithm}: the row route differs from the diag "
              f"route on the subset")
        check(ran["nw_row"] > 0 and ran["tb_decode_row"] > 0
              and ran["nw_diag"] == ran["tb_decode"] == 0,
              f"{algorithm}: the row route launched {ran}")
    return per


MAP_ARGS = ["-k", "15", "-w", "5", "--min-overlap-len", "100",
            "--min-overlap-fraction", "0.3", "--min-bases-per-residue", "500"]
MAP_STAGES = ("mapper.sketch", "mapper.index_sort", "mapper.match",
              "mapper.chain", "mapper.compact")    # top-level, disjoint
MAP_SUBSTAGES = ("mapper.match.count", "mapper.match.expand")


def map_reads(genome_len: int, n: int, median: int, seed: int):
    """(parser, reads) of n noisy reads (5 % error, both strands) from a
    random genome, by the port's simulators."""
    from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                          FastaSequence)
    from claragenomicsanalysis_tpu_torch.simulators import (
        NoisyReadSimulator, PoissonGenomeSimulator)
    genome = PoissonGenomeSimulator(seed=seed).build_reference(genome_len)
    reads = NoisyReadSimulator(seed=seed, error_rate=0.05).generate_reads(
        genome, n, median)
    return FastaParser("<mem>", records=[FastaSequence(r.name, r.seq)
                                         for r in reads]), reads


def map_truth(reads, rows, min_true: int = 2000) -> tuple[float, float]:
    """(precision, recall) of overlap rows against the reads' placements:
    the share of rows whose two reads overlap on the genome, and the share
    of ordered pairs overlapping by >= min_true bases that got a row."""
    import numpy as np
    st = np.array([r.reference_start for r in reads])
    en = np.array([r.reference_end for r in reads])
    q, t = rows[0].astype(np.int64), rows[1].astype(np.int64)
    precision = float(np.mean(np.minimum(en[q], en[t])
                              - np.maximum(st[q], st[t]) > 0))
    n = len(reads)
    found = np.unique(q * n + t)
    want = []
    for a in range(0, n, 1024):
        ov = (np.minimum(en[a:a + 1024, None], en[None, :])
              - np.maximum(st[a:a + 1024, None], st[None, :]))
        ia, ib = np.nonzero(ov >= min_true)
        keep = ia + a != ib
        want.append((ia[keep] + a) * n + ib[keep])
    want = np.concatenate(want)
    return precision, float(np.mean(np.isin(want, found)))


def phase_map_correctness():
    """Phase 19: ``cli map --device cuda`` against both map goldens, then
    10 Mbp of reads (1,000 x 10 kb, a 3 MB index budget: 4 chunks, 16
    chunk pairs) on the card against the port's CPU run, row for row."""
    import numpy as np
    from claragenomicsanalysis_tpu_torch import cli
    from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
    from claragenomicsanalysis_tpu_torch.models import mapper
    data = os.path.join(ROOT, "data")
    for inputs, golden in ((["sample_reads.fasta"], "sample_overlaps.paf"),
                           (["sample_reads.fasta", "sample_targets.fasta"],
                            "sample_qt.paf")):
        with open(os.path.join(data, "golden", golden)) as f:
            want = f.read()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["map"] + [os.path.join(data, x) for x in inputs]
                          + MAP_ARGS + ["--device", "cuda"])
        same = rc == 0 and buf.getvalue() == want
        print(f"phase 19 golden: map {' '.join(inputs)} --device cuda vs "
              f"data/golden/{golden}: {'identical' if same else 'DIFFERENT'}"
              f" ({len(want.splitlines())} lines)")
        check(same, f"cli map --device cuda differs from {golden}")
    t0 = time.perf_counter()
    parser, reads = map_reads(500_000, 1000, 10_000, SEED + 19)
    sim_s = time.perf_counter() - t0
    cfg = MapperConfig(index_size_mb=3)
    res, walls = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = mapper.map_all_vs_all(parser, cfg, device=dev)
        walls[dev] = time.perf_counter() - t0
    same = np.array_equal(res["cuda"].rows, res["cpu"].rows)
    precision, recall = map_truth(reads, res["cuda"].rows)
    print(f"phase 19 map 10 Mbp ({len(reads)} reads, 16 chunk pairs, reads "
          f"simulated in {sim_s:.1f} s): cuda {res['cuda'].rows.shape[1]} "
          f"overlaps in {walls['cuda']:.2f} s (first run), cpu "
          f"{res['cpu'].rows.shape[1]} in {walls['cpu']:.2f} s: rows "
          f"{'identical' if same else 'DIFFERENT'}, statuses "
          f"{sorted(set(s.name for s in res['cuda'].statuses))}; against the "
          f"placements: precision {precision:.4f}, recall {recall:.4f} "
          f"(pairs overlapping >= 2 kb)")
    check(same and res["cuda"].statuses == res["cpu"].statuses
          and len(res["cuda"].statuses) == 16,
          "phase 19: the card's rows or statuses differ from the CPU's")
    check(res["cuda"].rows.shape[1] > 0 and precision == 1.0
          and recall >= 0.99, f"phase 19: precision {precision}, recall "
          f"{recall}")


def phase_map_main() -> tuple:
    """Phase 20, the map main path at full size: 10,000 reads of median
    10 kb (100 Mbp, 20x of a 5 Mbp genome; scripts/bench_map_scale.py's
    default shape) through ``map_all_vs_all(..., device="cuda")`` at
    ``MapperConfig()``'s defaults (4 index chunks, 16 chunk pairs): one
    untimed warm-up, then a timed run with each mapper.* stage's device
    time by CUDA events.  -> (its figures, the timed run's MapResult, the
    reads)."""
    import collections
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
    from claragenomicsanalysis_tpu_torch.models import mapper
    from claragenomicsanalysis_tpu_torch.utils.genomeutils import encode
    from claragenomicsanalysis_tpu_torch.utils.profiling import stage_times
    t0 = time.perf_counter()
    parser, reads = map_reads(5_000_000, 10_000, 10_000, 11)
    sim_s = time.perf_counter() - t0
    total_bases = sum(len(r.seq) for r in reads)
    cfg = MapperConfig()
    n_chunks = len(parser.get_chunks(cfg.index_size_mb * 1_000_000))
    print(f"phase 20 data: {len(reads)} reads, {total_bases / 1e6:.3f} Mbp, "
          f"{n_chunks} index chunks, simulated in {sim_s:.1f} s (not in the "
          f"wall)")
    anchors = []
    create = mapper.Matcher.create_matcher

    def counted(*a, **k):
        m = create(*a, **k)
        anchors.append(m.n_anchors)
        return m

    mapper.Matcher.create_matcher = counted
    try:
        warm = mapper.map_all_vs_all(parser, cfg, device="cuda")
        torch.cuda.synchronize()
        anchors.clear()
        torch.cuda.reset_peak_memory_stats()
        with stage_times() as st:
            t0 = time.perf_counter()
            res = mapper.map_all_vs_all(parser, cfg, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ms = st.ms()
            host_ms = st.host_ms()
            calls = st.count()
    finally:
        mapper.Matcher.create_matcher = create
    peak = torch.cuda.max_memory_allocated()
    device_s = sum(ms.get(k, 0.0) for k in MAP_STAGES) / 1e3
    # two host parts of the run, re-run alone on the same data: the reads'
    # encoding into the chunks' (B, L) arrays (Index.create_index) and the
    # final merge (canonical order, Overlap objects)
    t0 = time.perf_counter()
    for f, p in parser.get_chunks(cfg.index_size_mb * 1_000_000):
        seqs = [parser.get_sequence_by_id(i).seq for i in range(f, p)]
        buf = np.full((len(seqs), max(map(len, seqs))), -1, dtype=np.int8)
        for i, sq in enumerate(seqs):
            buf[i, : len(sq)] = encode(sq)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapper.Overlapper.rows_to_overlaps(res.rows[:, mapper._canonical_order(
        res.rows)])
    merge_s = time.perf_counter() - t0
    n_ov = len(res.overlaps)
    statuses = collections.Counter(s.name for s in res.statuses)
    precision, recall = map_truth(reads, res.rows)
    out = {"reads": len(reads), "mbp": total_bases / 1e6,
           "chunk_pairs": len(res.statuses), "wall_s": wall,
           "mbp_per_s": total_bases / wall / 1e6, "overlaps": n_ov,
           "overlaps_per_s": n_ov / wall, "statuses": dict(statuses),
           "anchors": sum(anchors), "max_pair_anchors": max(anchors),
           "peak_device_bytes": peak, "device_stage_s": device_s,
           "host_s": wall - device_s, "host_share": (wall - device_s) / wall,
           "host_encode_s": encode_s, "host_merge_s": merge_s,
           "stage_ms": {k: ms[k] for k in MAP_STAGES + MAP_SUBSTAGES
                        if k in ms},
           "stage_host_ms": {k: host_ms[k] for k in MAP_STAGES
                             + MAP_SUBSTAGES if k in host_ms},
           "outside_stages_s": wall - sum(host_ms.get(k, 0.0)
                                          for k in MAP_STAGES) / 1e3,
           "stage_calls": {k: calls[k] for k in MAP_STAGES if k in calls},
           "precision": precision, "recall": recall}
    print(f"phase 20 map main path (100 Mbp, MapperConfig() defaults): "
          f"{n_ov} overlaps in {wall:.3f} s = {out['mbp_per_s']:.3f} Mbp/s, "
          f"{out['overlaps_per_s']:.1f} overlaps/s; statuses "
          f"{dict(statuses)}; {out['anchors']} anchors over "
          f"{len(anchors)} pairs (largest pair {out['max_pair_anchors']}); "
          f"peak device memory {peak / 2**30:.3f} GiB")
    print("phase 20 stages (device time by CUDA events / host time inside "
          "the range, ms): " + ", ".join(
              f"{k} {v:.3f} / {out['stage_host_ms'].get(k, 0.0):.3f} "
              f"({calls.get(k, 0)} ranges)"
              for k, v in out["stage_ms"].items())
          + f"; outside every range {out['outside_stages_s']:.3f} s")
    print(f"phase 20 host share: wall {wall:.3f} s - top-level stages "
          f"{device_s:.3f} s = {out['host_s']:.3f} s host "
          f"({out['host_share']:.4f} of the wall), of which the reads' "
          f"encoding {encode_s:.3f} s and the final merge {merge_s:.3f} s "
          f"(each re-run alone); against the placements: precision "
          f"{precision:.4f}, recall {recall:.4f}")
    print("phase 20 map: " + json.dumps(out))
    check(np.array_equal(res.rows, warm.rows) and n_ov > 0
          and res.statuses == warm.statuses,
          "phase 20: the timed run's rows differ from the warm-up's")
    lens = np.array([len(r.seq) for r in reads])
    r = res.rows
    check(((0 <= r[2]) & (r[2] < r[3]) & (r[3] <= lens[r[0]])
           & (0 <= r[4]) & (r[4] < r[5]) & (r[5] <= lens[r[1]])).all()
          and precision == 1.0 and recall >= 0.95,
          f"phase 20: rows out of range or precision {precision}, recall "
          f"{recall}")
    return out, res, reads


#: the compositions' mapper settings, MAP_ARGS as a MapperConfig
#: (scripts/bench_correct_scale.py's: k 15, w 5, min overlap 100, fraction
#: 0.3, 500 bases a residue)
COMPOSITION_MAPPER = dict(kmer_size=15, window_size=5, min_overlap_len=100,
                          min_overlap_fraction=0.3, min_bases_per_residue=500)
N_SPANS_PLAIN = 64       # phase 21's spans re-aligned on the CPU
REGION_BASES = 64_000    # phase 22's genome stretch of the resumed run


def composition_reads():
    """scripts/bench_correct_scale.py's default read set: 1,000 reads of
    5 kb at 5 % error, both strands, from a 500 kb genome (10x), by the
    port's simulators.  -> (parser, reads, genome)."""
    from claragenomicsanalysis_tpu_torch.io.fasta import (FastaParser,
                                                          FastaSequence)
    from claragenomicsanalysis_tpu_torch.simulators import (
        NoisyReadSimulator, PoissonGenomeSimulator)
    genome = PoissonGenomeSimulator(seed=13).build_reference(500_000)
    reads = NoisyReadSimulator(seed=13, error_rate=0.05).generate_reads(
        genome, 1000, 5000)
    return (FastaParser("<mem>", records=[FastaSequence(r.name, r.seq)
                                          for r in reads]), reads, genome)


def cli_golden(tag: str, argv: list, golden: str) -> None:
    """The port's CLI on ``argv`` byte for byte against a golden file."""
    from claragenomicsanalysis_tpu_torch import cli
    with open(os.path.join(ROOT, "data", "golden", golden)) as f:
        want = f.read()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    same = rc == 0 and buf.getvalue() == want
    print(f"{tag} golden: cli {argv[0]} {' '.join(argv[2:])} vs "
          f"data/golden/{golden}: {'identical' if same else 'DIFFERENT'} "
          f"({len(want.splitlines())} lines)")
    check(same, f"{tag}: cli {argv[0]} differs from {golden}")


def run_path(fn):
    """``fn()`` as a main path inside a ``stage_times()`` block, which
    counts its launches, every kernel launch and trace_range timed by CUDA
    events, the host clock around it ending in a sync.  -> dict(out, wall,
    launches, kt, st, peak, hirschberg)."""
    import torch
    from claragenomicsanalysis_tpu_torch.utils.profiling import (kernel_times,
                                                                 stage_times)
    settle_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with kernel_times() as kt, stage_times() as st:
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches(st, ALIGNER_KERNELS + POA_KERNELS)
    check(kt.count() == {k: v for k, v in launches.items() if v},
          f"timed launches {kt.count()} != counted {launches}")
    return dict(out=out, wall=wall, launches=launches, kt=kt, st=st,
                peak=torch.cuda.max_memory_allocated(),
                hirschberg=read_hirschberg(st))


def path_kernels(tag: str, run: dict, sm_mhz: float, window=None) -> dict:
    """A path's kernels line entries: each launched kernel's launches and
    device time in the run, and each replayed at its largest launch there
    against its plain version, with its time and bound (the banded NW with
    its decoder on the NW's traceback; B10 with ``window``, the path's
    (BatchSize, banded, msa)).  Names the kernel that spent the most device
    time in the run."""
    kt, launches = run["kt"], run["launches"]
    dev_ms = kt.ms()
    per = {k: {"launches": n, "run_ms": dev_ms.get(k, 0.0)}
           for k, n in launches.items() if n}
    print(f"{tag} kernels in the run (CUDA events): " + ", ".join(
        f"{k} {v['launches']} launches {v['run_ms']:.3f} ms"
        for k, v in per.items())
        + f"; most device time: {max(dev_ms, key=dev_ms.get)}")
    figs = {}
    if "nw_diag" in per:
        figs |= time_banded(*kt.largest["nw_diag"], sm_mhz,
                            f"{tag} largest B1 launch:")
    if "myers" in per:
        figs["myers"] = time_myers(*kt.largest["myers"], sm_mhz)
        m = figs["myers"]
        print(f"{tag} myers replayed at its largest launch ({m['shape']}): "
              f"kernel {m['ms']:.3f} ms vs plain {m['plain_ms']:.1f} ms, max "
              f"diff {m['err']}; bound {m['bound'][0]:.4f} ms "
              f"({m['bound'][1]})")
        check(m["err"] == 0, f"{tag}: myers disagrees with its plain "
              f"version at its largest launch")
    if "cigar" in per:
        figs["cigar"] = c = time_cigar(*kt.largest["cigar"], sm_mhz)
        print(f"{tag} cigar replayed at its largest launch ({c['shape']}): "
              f"kernel {c['ms']:.4f} ms (count {c['count_ms']:.4f} + write "
              f"{c['write_ms']:.4f}) vs plain {c['plain_ms']:.1f} ms, bytes "
              f"differing {c['err']}; bound {c['bound'][0]:.4f} ms "
              f"({c['bound'][1]})")
        check(c["err"] == 0, f"{tag}: cigar disagrees with its plain "
              f"version at its largest launch")
    for k in POA_STEPS:
        if k in per:
            figs[k] = replay_poa_kernel(tag, k, kt.largest[k], sm_mhz)
    if "poa_window" in per:
        figs["poa_window"], _ = replay_window_kernel(
            tag, kt.largest["poa_window"], *window, sm_mhz)
    check(set(figs) == set(per), f"{tag}: no replay for "
          f"{set(per) - set(figs)}")
    for k, v in figs.items():
        per[k].update({f: v[f] for f in REPLAY_FIGURES})
    kt.largest.clear()
    return per


def deepest_nwtb(fn):
    """``fn()`` with the lockstep route's graph-NW calls watched: -> (its
    result, the inputs of the B5 launch with the most pred slots, of those
    the most windows still adding a sequence, the latest of equal ones).
    Each call syncs to count its windows."""
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    nwtb = poa_window.graph_nw_traceback
    kept = {"key": (-1, -1), "args": None}

    def watched(*args):
        key = (args[6].shape[2], int(args[9].sum()))
        if key >= kept["key"]:
            kept.update(key=key, args=args)
        return nwtb(*args)

    poa_window.graph_nw_traceback = watched
    try:
        out = fn()
    finally:
        poa_window.graph_nw_traceback = nwtb
    return out, kept["args"]


def stage_lines(tag: str, run: dict, names) -> dict:
    """Each named trace_range's CUDA-event ms, host ms and entries in the
    run, printed; -> {name: (event ms, host ms, entries)}."""
    ms, host, calls = run["st"].ms(), run["st"].host_ms(), run["st"].count()
    out = {k: (ms[k], host[k], calls[k]) for k in names if k in ms}
    print(f"{tag} stages (CUDA events / host ms, entries): " + ", ".join(
        f"{k} {a:.3f} / {b:.3f} ({c})" for k, (a, b, c) in out.items()))
    print(f"{tag} the other ranges inside them, by host ms: " + ", ".join(
        f"{k} {ms[k]:.1f} / {host[k]:.1f} ({calls[k]})" for k in sorted(
            set(ms) - set(out), key=lambda k: -host[k])))
    return out


def phase_pipeline(parser, reads, sm_mhz: float) -> dict:
    """Phase 21: ``cli pipeline --device cuda`` against the golden, then
    the pipeline main path, ``run_pipeline(..., device="cuda")`` on the
    composition reads at PipelineConfig's defaults (band radius 256, spans
    up to 16,384) with its checks, rates, stages, kernels and recall.
    -> the path's kernels line entries."""
    import re
    import numpy as np
    from claragenomicsanalysis_tpu_torch.core.config import (MapperConfig,
                                                             PipelineConfig)
    from claragenomicsanalysis_tpu_torch.core.status import StatusType
    from claragenomicsanalysis_tpu_torch.evaluation import (TruthRecord,
                                                            evaluate_paf)
    from claragenomicsanalysis_tpu_torch.models import aligner, mapper
    from claragenomicsanalysis_tpu_torch.models import pipeline as pl
    data = os.path.join(ROOT, "data")
    cli_golden("phase 21", ["pipeline", f"{data}/sample_reads.fasta"]
               + MAP_ARGS + ["--band-radius", "256", "--device", "cuda"],
               "sample_pipeline.paf")
    cfg = PipelineConfig(mapper=MapperConfig(**COMPOSITION_MAPPER))
    run = run_path(lambda: pl.run_pipeline(parser, cfg, device="cuda"))
    res, wall = run["out"], run["wall"]
    launches = run["launches"]
    check(all(launches[k] > 0 for k in ("myers", "nw_diag", "tb_decode",
                                        "cigar"))
          and not any(launches[k] for k in POA_KERNELS + ("nw_row",
                                                          "tb_decode_row")),
          f"phase 21: the pipeline's kernels were not all launched, or "
          f"others were: {launches}")
    n = len(res.overlaps)
    spans = pl.overlap_spans(res.overlaps, parser)
    bases = sum(len(q) + len(t) for q, t in spans)
    buckets = pl.span_buckets(spans)
    dev_ms = run["kt"].ms()
    busy = sum(dev_ms.values())
    print(f"phase 21 pipeline main path ({len(reads)} reads x 5 kb, "
          f"PipelineConfig defaults): {n} overlaps aligned in {wall:.3f} s "
          f"= {res.n_aligned / wall:.1f} CIGAR'd alignments/s = "
          f"{bases / wall / 1e6:.3f} Mbp/s of spans (query + target) end to "
          f"end; n_align_failed={res.n_align_failed}; span buckets "
          f"{ {b: len(v) for b, v in sorted(buckets.items())} }; Hirschberg "
          f"{run['hirschberg'][0]} pairs, {run['hirschberg'][1]} levels; "
          f"kernel share {busy / (wall * 1e3):.4f} ({busy:.1f} ms); peak "
          f"device memory {run['peak'] / 2**30:.3f} GiB")
    stages = stage_lines("phase 21", run, (
        "pipeline.map", "pipeline.align", "aligner.pack", "aligner.myers",
        "aligner.myers.score", "aligner.myers.banded", "aligner.hirschberg"))
    top_ms = sum(stages[k][0] for k in ("pipeline.map", "pipeline.align"))
    print(f"phase 21 host share: wall {wall * 1e3:.1f} ms, top-level ranges "
          f"{top_ms:.1f} ms by their events; kernels {busy:.1f} ms, so "
          f"{1 - busy / (wall * 1e3):.4f} of the wall is host work or torch "
          f"ops outside the hand-written kernels; the CIGAR strings "
          f"(pipeline.cigar) {run['st'].host_ms()['pipeline.cigar']:.1f} ms "
          f"of pipeline.align's host time")
    check(res.n_align_failed == 0 and res.n_aligned == n > 0,
          f"phase 21: {res.n_align_failed} of {n} alignments failed")
    # every CIGAR consumes its spans; the rows without cg:Z are the map's
    for row in res.paf_rows:
        cols = row.split("\t")
        qc = tc = 0
        for num, op in re.findall(r"(\d+)([MID])", cols[12][5:]):
            qc += int(num) * (op in "MI")
            tc += int(num) * (op in "MD")
        check((qc, tc) == (int(cols[3]) - int(cols[2]),
                           int(cols[8]) - int(cols[7])),
              f"phase 21: a CIGAR does not consume its spans: {row[:80]}")
    ref = mapper.map_all_vs_all(parser, cfg.mapper, device="cuda")
    kept = [o for o in ref.overlaps
            if pl.within_length(o, cfg.max_alignment_length)]
    same_rows = ["\t".join(r.split("\t")[:12]) for r in res.paf_rows] == \
        mapper.overlaps_to_paf(kept, parser)
    # 64 spans, spread over the buckets, through the CPU plain path at
    # their bucket's shape
    order = np.argsort([max(len(q), len(t)) for q, t in spans], kind="stable")
    pick = sorted(int(i) for i in order[np.linspace(
        0, n - 1, min(N_SPANS_PLAIN, n)).astype(int)])
    t0 = time.perf_counter()
    cpu_same = True
    for blen, idxs in pl.span_buckets([spans[i] for i in pick]).items():
        al = aligner.create_aligner(blen, blen, len(idxs),
                                    band_radius=min(cfg.aligner_band_radius,
                                                    blen),
                                    algorithm="myers", device="cpu")
        for i in idxs:
            al.add_alignment(*spans[pick[i]])
        for i, a in zip(idxs, al.get_alignments()):
            cpu_same &= (a.status == StatusType.SUCCESS
                         and a.convert_to_cigar()
                         == res.overlaps[pick[i]].cigar)
    t_cpu = time.perf_counter() - t0
    truth = {r.name: TruthRecord(r.name, r.reference_start, r.reference_end,
                                 r.strand) for r in reads}
    metrics = evaluate_paf(({"query_name": r.split("\t")[0],
                             "target_name": r.split("\t")[5]}
                            for r in res.paf_rows), truth)
    print(f"phase 21 checks: every CIGAR consumes its spans; the rows "
          f"without cg:Z equal map_all_vs_all's under the same filter: "
          f"{same_rows}; {len(pick)} spans through the CPU plain path in "
          f"{t_cpu:.1f} s give the same CIGARs: {cpu_same}; evaluate_paf "
          f"against the reads' placements: {json.dumps(metrics)}")
    check(same_rows, "phase 21: the pipeline's rows differ from the map's")
    check(cpu_same, "phase 21: the CPU plain path gives other CIGARs")
    check(metrics["precision"] > 0.95 and metrics["recall"] > 0.9,
          f"phase 21: recall/precision {metrics}")
    return path_kernels("phase 21", run, sm_mhz)


def myers_distances(pairs) -> "np.ndarray":
    """Edit distances of string pairs by the Myers kernel (B4) on the card,
    128 pairs a launch."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import myers
    out = []
    for s in range(0, len(pairs), 128):
        arrays = pack(pairs[s:s + 128])
        _, sc = myers.myers_bottom_row(*(torch.from_numpy(a).cuda()
                                         for a in arrays))
        out.append(sc.cpu().numpy())
    return np.concatenate(out).astype(np.int64)


def phase_correct(parser, reads, genome, sm_mhz: float) -> tuple:
    """Phase 22: ``cli correct --device cuda`` against the golden (both POA
    routes), then the correction main path, ``correct_reads(...,
    device="cuda")`` on the composition reads at
    scripts/bench_correct_scale.py's CorrectConfig (window 128,
    max_support 7), with its rate, windows, stages and their host share,
    kernels and the edit distance to each read's true span before and
    after; then a run stopped after one part and resumed, on the reads of
    the genome's first 64 kb, equal to the uninterrupted run; then those
    reads at cli
    correct's max_support of 15, B5 held against its plain version at its
    deepest launch (16 pred slots).  -> the path's kernels line entries,
    and B5's variant at cli correct's max_support."""
    import shutil
    from dataclasses import replace
    from claragenomicsanalysis_tpu_torch.core.config import (CorrectConfig,
                                                             MapperConfig)
    from claragenomicsanalysis_tpu_torch.io.fasta import FastaParser
    from claragenomicsanalysis_tpu_torch.models import correct
    from claragenomicsanalysis_tpu_torch.utils.genomeutils import \
        reverse_complement
    data = os.path.join(ROOT, "data")
    for extra in ([], ["--poa-backend", "pallas"]):
        cli_golden("phase 22", ["correct", f"{data}/sample_reads.fasta"]
                   + MAP_ARGS + extra + ["--device", "cuda"],
                   "sample_corrected.fasta")
    cfg = CorrectConfig(mapper=MapperConfig(**COMPOSITION_MAPPER))
    run = run_path(lambda: correct.correct_reads(parser, cfg, device="cuda"))
    res, wall = run["out"], run["wall"]
    launches = run["launches"]
    want = ("nw_diag", "tb_decode", "poa_topsort", "poa_nwtb", "poa_add",
            "poa_consensus")
    check(all(launches[k] > 0 for k in want) and not any(
        launches[k] for k in ("nw_row", "tb_decode_row", "poa_msa",
                              "poa_window", "cigar")),
          f"phase 22: the correction's kernels were not all launched, or "
          f"others were: {launches}")
    bases = sum(len(r.seq) for r in reads)
    dev_ms = run["kt"].ms()
    busy = sum(dev_ms.values())
    print(f"phase 22 correct main path ({len(reads)} reads x 5 kb, "
          f"window {cfg.window_length}, max_support {cfg.max_support}): "
          f"{wall:.3f} s = {bases / wall:.1f} corrected bases/s end to end; "
          f"windows polished {res.n_polished} / total {res.n_windows} / "
          f"failed {res.n_window_failed}; Hirschberg {run['hirschberg'][0]} "
          f"pairs; kernel share {busy / (wall * 1e3):.4f} ({busy:.1f} ms); "
          f"peak device memory {run['peak'] / 2**30:.3f} GiB")
    stages = stage_lines("phase 22", run, (
        "correct.map", "correct.align", "correct.windows", "correct.poa",
        "aligner.banded-escalate", "aligner.hirschberg", "poa.generate"))
    map_dev = sum(v for k, v in run["st"].ms().items() if k in MAP_STAGES)
    kernel_of = {"correct.map": map_dev,
                 "correct.align": sum(dev_ms.get(k, 0.0)
                                      for k in ALIGNER_KERNELS),
                 "correct.windows": 0.0,
                 "correct.poa": sum(dev_ms.get(k, 0.0) for k in POA_KERNELS)}
    print("phase 22 host share per stage (1 - device ms / host ms; device: "
          "the hand-written kernels, for correct.map the mapper.* ranges' "
          "events): " + ", ".join(
              f"{k} {1 - kernel_of[k] / max(stages[k][1], 1e-9):.4f} "
              f"({kernel_of[k]:.1f} of {stages[k][1]:.1f} ms)"
              for k in kernel_of if k in stages)
          + f"; outside every correct.* range "
          f"{wall * 1e3 - sum(stages[k][1] for k in kernel_of):.1f} ms")
    check(res.n_polished > 0.5 * res.n_windows,
          f"phase 22: only {res.n_polished} of {res.n_windows} windows "
          f"polished")

    def truth(r):
        span = genome[r.reference_start:r.reference_end]
        return reverse_complement(span) if r.strand == "-" else span
    truths = [truth(r) for r in reads]
    before = myers_distances([(r.seq, t) for r, t in zip(reads, truths)])
    after = myers_distances(list(zip(res.seqs, truths)))
    print(f"phase 22 quality: mean edit distance to the true span "
          f"{before.mean():.2f} before, {after.mean():.2f} after (reduction "
          f"{1 - after.sum() / max(before.sum(), 1):.4f}; by the Myers "
          f"kernel on the card)")
    check(after.mean() < before.mean(), "phase 22: correction did not "
          "lower the mean edit distance to the truth")

    # the reads that start in the genome's first 64 kb: the main path's
    # coverage (10x) on a stretch of it
    ids = [i for i, r in enumerate(reads) if r.reference_start < REGION_BASES]
    sub = FastaParser("<mem>", records=[parser.get_sequence_by_id(i)
                                        for i in ids])
    whole = correct.correct_reads(sub, cfg, device="cuda")
    work = os.path.join(ROOT, "build", "smoke_correct_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        correct.correct_reads(sub, cfg, work_dir=work, fail_after_parts=1,
                              device="cuda")
        stopped = False
    except RuntimeError:
        stopped = True
    resumed = correct.correct_reads(sub, cfg, work_dir=work, device="cuda")
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 22 resume: the {len(ids)} reads that start in the first "
          f"{REGION_BASES} bases, in {-(-len(ids) // 64)} parts, stopped "
          f"after one: {stopped}; resumed equals the uninterrupted run: "
          f"{resumed == whole}")
    check(stopped and resumed == whole, "phase 22: the resumed run differs")

    # cli correct's max_support of 15: depth buckets up to 16 sequences,
    # B5 at P = 16 and N = 384, held against its plain version there
    deep_cfg = replace(cfg, max_support=15)
    deep, args = deepest_nwtb(
        lambda: correct.correct_reads(sub, deep_cfg, device="cuda"))
    fig = replay_poa_kernel("phase 22 max_support 15", "poa_nwtb", args,
                            sm_mhz)
    print(f"phase 22 max_support 15 on the {len(ids)} reads: "
          f"{deep.n_polished} / {deep.n_windows} windows polished, "
          f"{deep.n_window_failed} failed; deepest B5 launch {fig['shape']}")
    check(args[6].shape[2] == 16 and deep.n_polished > 0,
          f"phase 22: no B5 launch at 16 pred slots ({fig['shape']})")
    variant = {"variant": "phase 22 correct, max_support 15, deepest "
                          "bucket", **fig}
    return (path_kernels("phase 22", run, sm_mhz), {"poa_nwtb": [variant]},
            res.seqs)


def compositions_main() -> int:
    """``--compositions``: phases 1, 21 and 22 alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sm_mhz = phase_env()
    t0 = time.perf_counter()
    parser, reads, genome = composition_reads()
    print(f"phases 21-22 data: {len(reads)} reads, "
          f"{sum(len(r.seq) for r in reads) / 1e6:.3f} Mbp, simulated in "
          f"{time.perf_counter() - t0:.1f} s")
    paths = {"pipeline": phase_pipeline(parser, reads, sm_mhz)}
    paths["correct"], variants, _ = phase_correct(parser, reads, genome,
                                                  sm_mhz)
    print(json.dumps({"paths": paths, "variants": variants}, default=str))
    return 0

# ----------------------------------------------------- multi-rank (23)

RING_SP_MIN_LEN = 4096   # phase 23c: levels of this side or more take the ring
PHASE23_DIR = os.path.join(ROOT, "build", "smoke_phase23")


def align_digest(results) -> str:
    """sha256 of alignments' statuses, distances and paths."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for r in results:
        h.update(f"{int(r.status)},{r.edit_distance},{len(r.path)};".encode())
        h.update(np.asarray(r.path, np.int8).tobytes())
    return h.hexdigest()


def poa_digest(run: dict) -> str:
    """sha256 of a POA run's consensus, coverage and statuses."""
    import hashlib
    h = hashlib.sha256()
    for c, cov, st in zip(run["cons"], run["covs"], run["stats"]):
        h.update(f"{c};{cov};{int(st)}|".encode())
    return h.hexdigest()


def rows_digest(rows, statuses) -> str:
    import hashlib
    import numpy as np
    h = hashlib.sha256(np.ascontiguousarray(rows).tobytes())
    h.update(repr(rows.shape).encode() + repr([int(x) for x in statuses])
             .encode())
    return h.hexdigest()


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f">{r.name}\n{r.seq}\n")


def phase23_map_refs(res, reads) -> dict:
    """Phase 20's reads as a FASTA file for the ranks, and its rows."""
    os.makedirs(PHASE23_DIR, exist_ok=True)
    path = os.path.join(PHASE23_DIR, "map_reads.fasta")
    write_fasta(path, reads)
    return {"map_fasta": path, "map": rows_digest(res.rows, res.statuses),
            "map_bases": sum(len(r.seq) for r in reads),
            "map_overlaps": res.rows.shape[1]}


def phase23_correct_refs(reads, corrected) -> dict:
    """Phase 22's reads as a FASTA file for the ranks, and its corrected
    reads."""
    import hashlib
    os.makedirs(PHASE23_DIR, exist_ok=True)
    path = os.path.join(PHASE23_DIR, "correct_reads.fasta")
    write_fasta(path, reads)
    return {"correct_fasta": path,
            "correct": hashlib.sha256("\n".join(corrected).encode())
            .hexdigest(),
            "correct_bases": sum(len(r.seq) for r in reads)}


def rank_path(fn, tag: str, sm_mhz: float, window=None) -> dict:
    """``fn()`` on this rank as a main path (run_path): its launches and
    counters, kernel launches and trace ranges timed, the host clock ending
    in a sync, the rank's peak memory.  Then rank 0
    replays each kernel of its run at its largest launch against its plain
    version (path_kernels; ``window`` as there), at the shapes this rank's
    share gave them, and the ranks wait for each other, so that no rank's
    next path holds rank 0's replays."""
    import torch.distributed as dist
    from claragenomicsanalysis_tpu_torch.parallel import multihost
    run = run_path(fn)
    ms = run["kt"].ms()
    figs = {}
    if multihost.is_writer() and any(run["launches"].values()):
        figs = path_kernels(f"{tag} rank 0", run, sm_mhz, window)
    run["kt"].largest.clear()
    dist.barrier()
    return dict(out=run["out"], wall=run["wall"], peak=run["peak"],
                launches={k: v for k, v in run["launches"].items() if v},
                kernel_ms=ms, host_ms=run["st"].host_ms(),
                stage_ms=run["st"].ms(), hirschberg=run["hirschberg"],
                counters=dict(run["st"].counters),
                figs={k: {f: v[f] for f in REPLAY_FIGURES}
                      for k, v in figs.items()})


def phase23_rank(refs: dict) -> dict:
    """One rank of phase 23, in a process of its own (run_ranks): the four
    multi-rank paths in turn; -> digests and figures, nothing large."""
    import hashlib
    import torch
    from claragenomicsanalysis_tpu_torch import create_aligner
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             CorrectConfig,
                                                             MapperConfig)
    from claragenomicsanalysis_tpu_torch.io.fasta import create_fasta_parser
    from claragenomicsanalysis_tpu_torch.models import correct, mapper, poa
    from claragenomicsanalysis_tpu_torch.parallel.mesh import (axis_meshes,
                                                               make_mesh)
    out = {"device": str(torch.device("cuda", torch.cuda.current_device()))}
    sm = refs["sm_mhz"]
    mesh = make_mesh()
    _, rep = axis_meshes(mesh)

    # 23a: the map on 'rep', a warm-up and a timed run
    parser = create_fasta_parser(refs["map_fasta"])
    cfg = MapperConfig()
    warm = mapper.map_all_vs_all(parser, cfg, device="cuda", mesh=rep)
    run = rank_path(lambda: mapper.map_all_vs_all(parser, cfg, device="cuda",
                                                  mesh=rep), "phase 23a", sm)
    res = run.pop("out")
    out["map"] = dict(run, digest=rows_digest(res.rows, res.statuses),
                      warm_same=rows_digest(warm.rows, warm.statuses)
                      == rows_digest(res.rows, res.statuses),
                      a2a_bytes=run["counters"].get("comm.all_to_all_bytes",
                                                    0))
    del parser, warm, res

    # 23b: the correction on both views
    parser = create_fasta_parser(refs["correct_fasta"])
    ccfg = CorrectConfig(mapper=MapperConfig(**COMPOSITION_MAPPER))
    run = rank_path(lambda: correct.correct_reads(parser, ccfg,
                                                  device="cuda", mesh=mesh),
                    "phase 23b", sm)
    res = run.pop("out")
    out["correct"] = dict(run, digest=hashlib.sha256(
        "\n".join(res.seqs).encode()).hexdigest(), windows=(
            res.n_polished, res.n_windows, res.n_window_failed))
    del parser, res

    # 23c: ukkonen on 'data', both POA routes on 'data', Hirschberg on 'sp'
    pairs = refs["pairs"]

    def align(sub, algorithm, m, **kw):
        al = create_aligner(max(len(a) for a, _ in sub),
                            max(len(b) for _, b in sub), len(sub),
                            band_radius=64, algorithm=algorithm,
                            device="cuda", mesh=m, **kw)
        for a, b in sub:
            al.add_alignment(a, b)
        return al.get_alignments()

    run = rank_path(lambda: align(pairs, "ukkonen", mesh), "phase 23c ukkonen",
                    sm)
    out["ukkonen"] = dict(run, digest=align_digest(run.pop("out")))
    bs = BatchSize(**refs["poa_cfg"])
    for kernel in ("lockstep", "window"):
        def poa_run():
            b = poa.create_batch(bs, max_poas=len(refs["poa_windows"]),
                                 device="cuda", kernel=kernel, mesh=mesh)
            for w in refs["poa_windows"]:
                b.add_poa_group(w)
            return b.get_consensus()
        run = rank_path(poa_run, f"phase 23c POA {kernel}", sm,
                        (bs, False, False))
        cons, covs, stats = run.pop("out")
        out[f"poa_{kernel}"] = dict(run, digest=poa_digest(
            dict(cons=cons, covs=covs, stats=stats)))
    sp = make_mesh(data=1, sp=mesh.size)
    run = rank_path(lambda: align(pairs[:N_SUBSET], "hirschberg-myers", sp,
                                  sp_min_len=RING_SP_MIN_LEN),
                    "phase 23c hirschberg", sm)
    out["hirschberg"] = dict(run, digest=align_digest(run.pop("out")),
                             ring_levels=run["counters"].get(
                                 "hirschberg.ring_levels", 0))
    return out


def phase23_cli(n_cards: int) -> None:
    """23d: ``cli <sub> -d 2 --device cuda``; byte-equal to the goldens on
    two cards (a process each), refused with the JAX message on one
    (``cli.main`` in this process: the refusal raises SystemExit with the
    message before any rank starts, which a process would print to stderr
    and exit 1 with)."""
    from claragenomicsanalysis_tpu_torch import cli
    data = os.path.join(ROOT, "data")
    runs = {"align": (["align", f"{data}/sample_queries.fasta",
                       f"{data}/sample_targets.fasta"], "sample_align.txt"),
            "poa": (["poa", f"{data}/sample-windows.txt"],
                    "sample_consensus.txt"),
            "map": (["map", f"{data}/sample_reads.fasta"] + MAP_ARGS,
                    "sample_overlaps.paf"),
            "pipeline": (["pipeline", f"{data}/sample_reads.fasta"]
                         + MAP_ARGS, "sample_pipeline.paf"),
            "correct": (["correct", f"{data}/sample_reads.fasta"] + MAP_ARGS,
                        "sample_corrected.fasta")}
    for sub, (argv, golden) in runs.items():
        argv = ["--log-level", "WARNING"] + argv + ["--device", "cuda", "-d",
                                                    "2"]
        t0 = time.perf_counter()
        if n_cards >= 2:
            p = subprocess.run([sys.executable, "-m",
                                "claragenomicsanalysis_tpu_torch.cli"] + argv,
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            with open(os.path.join(data, "golden", golden)) as f:
                same = p.returncode == 0 and p.stdout == f.read()
            print(f"phase 23d cli {sub} -d 2 --device cuda: rc "
                  f"{p.returncode}, {'identical to' if same else 'DIFFERENT from'}"
                  f" data/golden/{golden} ({time.perf_counter() - t0:.1f} s)")
            check(same, f"phase 23d: cli {sub} -d 2 differs from {golden}")
        else:
            msg = "--devices 2 but only 1 available"
            try:
                cli.main(argv)
                exit_with = None
            except SystemExit as e:
                exit_with = e.code
            print(f"phase 23d cli {sub} -d 2 --device cuda on one card: "
                  f"SystemExit({exit_with!r})")
            check(exit_with == msg, f"phase 23d: cli {sub} -d 2 on one card "
                  f"did not refuse with {msg!r}")


def phase_multi_rank(refs: dict) -> dict:
    """Phase 23: the multi-rank paths (see the module docstring), each
    against its one-rank phase.  -> the kernels line's entries of its
    paths, launches and device ms summed over the ranks."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import _build
    from claragenomicsanalysis_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if n_cards >= 2 else ["cuda:0", "cuda:0"]
    backend = multihost.choose_backend(devices)
    _build.build()                     # the ranks load the built library
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = multihost.run_ranks(phase23_rank, len(devices), devices,
                                args=(refs,), timeout=600,
                                log_level="WARNING")
    span = time.perf_counter() - t0
    print(f"phase 23 ranks: {len(devices)} on {devices} ({backend}: "
          f"{'a card a rank' if backend == 'nccl' else 'ranks that share a card; two ranks on one card measure the code path, not scaling'}"
          f"), {span:.1f} s from spawn to the last result, devices "
          f"{[r['device'] for r in ranks]}")

    def per_rank(key, fmt):
        return "; ".join(f"rank {i}: {fmt(r[key])}" for i, r in
                         enumerate(ranks))

    # 23a
    walls = [r["map"]["wall"] for r in ranks]
    wall = max(walls)
    print(f"phase 23a map on rep = 2 ({refs['map_bases'] / 1e6:.3f} Mbp, "
          f"MapperConfig(), {refs['map_overlaps']} overlaps): wall "
          f"{wall:.3f} s (slowest rank) = {refs['map_bases'] / wall / 1e6:.3f}"
          f" Mbp/s; " + per_rank("map", lambda m: (
              f"wall {m['wall']:.3f} s, all_to_all {m['a2a_bytes']} B in "
              f"{m['host_ms'].get('mapper.all_to_all', 0.0):.1f} ms (host), "
              f"peak {m['peak'] / 2**30:.3f} GiB, stages (host ms) "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                  m['host_ms'].items()) if k.startswith("mapper.")))))
    check(all(r["map"]["digest"] == refs["map"] and r["map"]["warm_same"]
              for r in ranks),
          "phase 23a: the rep-sharded map's rows differ from phase 20's")
    print("phase 23a checks: every rank's rows and statuses equal phase "
          "20's one-rank run, warm-up and timed run alike")

    # 23b
    walls = [r["correct"]["wall"] for r in ranks]
    wall = max(walls)
    print(f"phase 23b correct on two ranks ({refs['correct_bases']} bases, "
          f"map on rep, reads dealt on data): wall {wall:.3f} s (slowest "
          f"rank) = {refs['correct_bases'] / wall:.1f} corrected bases/s; "
          + per_rank("correct", lambda c: (
              f"wall {c['wall']:.3f} s, kernel share "
              f"{sum(c['kernel_ms'].values()) / (c['wall'] * 1e3):.4f} "
              f"({sum(c['kernel_ms'].values()):.1f} ms), windows "
              f"{c['windows']}, peak {c['peak'] / 2**30:.3f} GiB, "
              f"launches {c['launches']}")))
    check(all(r["correct"]["digest"] == refs["correct"] for r in ranks),
          "phase 23b: the corrected reads differ from phase 22's")
    print("phase 23b checks: every rank's corrected reads equal phase 22's")

    # 23c
    for key, tag, ref in (("ukkonen", "ukkonen on data = 2, phase 5's "
                           f"{len(refs['pairs'])} pairs", "ukkonen"),
                          ("poa_lockstep", "POA lockstep on data = 2, phase "
                           f"12's {len(refs['poa_windows'])} windows", "poa"),
                          ("poa_window", "POA window route on data = 2, "
                           "phase 12's windows", "poa"),
                          ("hirschberg", f"hirschberg-myers on sp = 2, "
                           f"levels >= {RING_SP_MIN_LEN} on the ring, phase "
                           f"7's first {N_SUBSET} pairs", "hirschberg")):
        same = all(r[key]["digest"] == refs[ref] for r in ranks)
        extra = ""
        if key == "hirschberg":
            lv = ranks[0][key]["ring_levels"]
            ring_ms = ranks[0][key]["host_ms"].get("hirschberg.ring", 0.0)
            extra = (f"; {lv} ring levels, {ring_ms / max(lv, 1):.1f} ms a "
                     f"level (host, rank 0); {ranks[0][key]['hirschberg']}")
            check(lv >= 1, "phase 23c: no Hirschberg level took the ring")
        print(f"phase 23c {tag}: " + per_rank(key, lambda c: (
            f"wall {c['wall']:.3f} s, launches {c['launches']}"))
            + f"; equal to the one-rank phase: {same}{extra}")
        check(same, f"phase 23c: {key} on two ranks differs from one rank")

    phase23_cli(n_cards)
    import shutil
    shutil.rmtree(PHASE23_DIR, ignore_errors=True)
    print(f"phase 23 total: {time.perf_counter() - t_phase:.1f} s")

    names = {"map": "map_rep2", "correct": "correct_2ranks",
             "ukkonen": "ukkonen_data2", "poa_lockstep": "poa_data2",
             "poa_window": "poa_window_data2", "hirschberg": "hirschberg_sp2"}
    paths = {}
    for key, path in names.items():
        per = {}
        for r in ranks:
            for k, n in r[key]["launches"].items():
                e = per.setdefault(k, {"launches": 0, "run_ms": 0.0})
                e["launches"] += n
                e["run_ms"] += r[key]["kernel_ms"].get(k, 0.0)
        check(set(ranks[0][key]["figs"]) == set(ranks[0][key]["launches"]),
              f"phase 23: {path} has no replay on rank 0 for "
              f"{set(ranks[0][key]['launches']) - set(ranks[0][key]['figs'])}")
        for k, v in ranks[0][key]["figs"].items():
            per[k].update(v)
        if per:
            paths[path] = per
    check(all(paths[p] for p in names.values() if p != "map_rep2"),
          "phase 23: a multi-rank path launched no kernel")
    return paths


def multi_rank_main() -> int:
    """``--multi-rank``: phases 1 and 23 alone, with their own one-rank
    references (phase 5's pairs through ukkonen and myers, phase 12's
    windows, phase 20's map, phase 22's correction)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             CorrectConfig,
                                                             MapperConfig)
    from claragenomicsanalysis_tpu_torch.models import correct, mapper
    sm_mhz = phase_env()
    pairs = main_path_pairs(N_PAIRS, SEED)
    _, ukk, _ = run_aligner(pairs, "ukkonen")
    _, myers, _ = run_aligner(pairs[:N_SUBSET], "myers")
    S = POA_CORR["max_sequences_per_poa"]
    bs = BatchSize(**POA_CORR)
    _, windows, _ = poa_window_arrays(N_POA, 128, S, max(5, 128 // 20),
                                      bs.padded_seq, SEED + 20 + S)
    corr = run_poa_batch(bs, windows, False, False, "lockstep")
    refs = {"pairs": pairs, "ukkonen": align_digest(ukk),
            "hirschberg": align_digest(myers), "poa_cfg": POA_CORR,
            "poa_windows": windows, "poa": poa_digest(corr),
            "sm_mhz": sm_mhz}
    parser, reads = map_reads(5_000_000, 10_000, 10_000, 11)
    refs |= phase23_map_refs(mapper.map_all_vs_all(parser, MapperConfig(),
                                                   device="cuda"), reads)
    del parser, reads
    parser, reads, _ = composition_reads()
    cfg = CorrectConfig(mapper=MapperConfig(**COMPOSITION_MAPPER))
    refs |= phase23_correct_refs(
        reads, correct.correct_reads(parser, cfg, device="cuda").seqs)
    print(json.dumps({"paths": phase_multi_rank(refs)}))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    sm_mhz = phase_env()
    errs, b1_plans = phase_kernels(np.random.default_rng(SEED), sm_mhz)
    for k, v in phase_decode_thresholds(np.random.default_rng(SEED + 4),
                                        sm_mhz).items():
        errs[k] = max(errs[k], v)
    phase_golden()
    t0 = time.perf_counter()
    pairs = main_path_pairs(N_PAIRS, SEED)
    print(f"phase 5 data: {N_PAIRS} pairs, query 2-10 kb, max_q="
          f"{max(len(a) for a, _ in pairs)} max_t="
          f"{max(len(b) for _, b in pairs)}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    ukk = phase_main(pairs, sm_mhz)
    errs["myers"], c9 = phase_myers_edges(np.random.default_rng(SEED + 3),
                                          sm_mhz)
    paths = {"ukkonen": ukk["kernels"]}
    paths["myers"], myers_results = phase_myers_main(pairs, ukk, sm_mhz)
    phase_short_reads()
    phase_cli_algorithms()
    errs |= dict.fromkeys(POA_KERNELS, phase_poa_kernels())
    errs["poa_nwtb"] = max(errs["poa_nwtb"], phase_nwtb_variants())
    phase_poa_cli()
    paths["poa"], corr = phase_poa_main("phase 12", POA_CORR, N_POA, 128,
                                        max(5, 128 // 20), False, sm_mhz)
    paths["poa_deep"], deep = phase_poa_main("phase 13", POA_DEEP,
                                             N_POA_DEEP, 256, 12, True,
                                             sm_mhz)
    paths["poa_msa"], msa = phase_poa_main("phase 14", POA_MSA, N_POA, 100,
                                           max(5, 100 // 20), False, sm_mhz,
                                           msa=True)
    b10_plans = []
    for key, tag, ref in (("poa_window_msa", "phase 15 (MSA shape)", msa),
                          ("poa_window", "phase 15 (correction shape)", corr),
                          ("poa_window_deep", "phase 15 (deep shape)", deep)):
        paths[key], forced = phase_poa_window(tag, ref, sm_mhz)
        b10_plans.append(forced)
    paths["ukkonen_row"] = phase_row(pairs, ukk, myers_results[:N_SUBSET],
                                     sm_mhz)
    variants = {"myers": [c9], "nw_diag": b1_plans, "poa_window": b10_plans}
    for more in (phase_c8_align(sm_mhz), phase_c8_poa(sm_mhz)):
        for k, v in more.items():
            variants.setdefault(k, []).extend(v)

    phase_map_correctness()
    refs = {"pairs": pairs, "ukkonen": align_digest(ukk["results"]),
            "hirschberg": align_digest(myers_results[:N_SUBSET]),
            "poa_cfg": corr["cfg"], "poa_windows": corr["windows"],
            "poa": poa_digest(corr), "sm_mhz": sm_mhz}
    _, map_res, map_reads_ = phase_map_main()
    refs |= phase23_map_refs(map_res, map_reads_)
    del map_res, map_reads_
    t0 = time.perf_counter()
    parser, reads, genome = composition_reads()
    print(f"phases 21-22 data: {len(reads)} reads, "
          f"{sum(len(r.seq) for r in reads) / 1e6:.3f} Mbp, simulated in "
          f"{time.perf_counter() - t0:.1f} s (not in the walls)")
    paths["pipeline"] = phase_pipeline(parser, reads, sm_mhz)
    paths["correct"], more, corrected = phase_correct(parser, reads, genome,
                                                      sm_mhz)
    for k, v in (FORCED_PLANS | more).items():
        variants.setdefault(k, []).extend(v)
    refs |= phase23_correct_refs(reads, corrected)
    del corrected
    paths |= phase_multi_rank(refs)

    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "claragenomicsanalysis_tpu")
                    or m.startswith(("jax.", "claragenomicsanalysis_tpu.")))
    check(not loaded, f"the port loaded the JAX package or jax: {loaded}")

    csrc = "claragenomicsanalysis_tpu_torch/csrc"
    jax_ops = "claragenomicsanalysis_tpu/ops"
    v2 = "claragenomicsanalysis_tpu/ops/poa_pallas2.py"
    meta = {
        "nw_diag": ("claragenomicsanalysis_tpu_torch/csrc/nw_diag.cu",
                    "claragenomicsanalysis_tpu/ops/nw_diag_pallas.py:93"),
        "tb_decode": ("claragenomicsanalysis_tpu_torch/csrc/tb_decode.cu",
                      "claragenomicsanalysis_tpu/ops/tb_decode_pallas.py:33"),
        "nw_row": (f"{csrc}/nw_row.cu", f"{jax_ops}/nw_band_pallas.py:73"),
        "tb_decode_row": (f"{csrc}/tb_decode.cu",
                          f"{jax_ops}/tb_decode_pallas.py:33"),
        "myers": ("claragenomicsanalysis_tpu_torch/csrc/myers.cu",
                  "claragenomicsanalysis_tpu/ops/myers_pallas.py:39"),
        "poa_nwtb": (f"{csrc}/poa_nwtb.cu", f"{v2}:193"),
        "poa_add": (f"{csrc}/poa_add.cu", f"{v2}:640"),
        "poa_topsort": (f"{csrc}/poa_topsort.cu", f"{v2}:1006"),
        "poa_consensus": (f"{csrc}/poa_consensus.cu", f"{v2}:1196"),
        "poa_msa": (f"{csrc}/poa_msa.cu", f"{v2}:1482"),
        "poa_window": (f"{csrc}/poa_window.cu",
                       "claragenomicsanalysis_tpu/ops/poa_pallas.py:88"),
    }
    kernels = []
    for k, (src, rep) in meta.items():
        runs = {p: v[k] for p, v in paths.items() if k in v}
        timed = {p: v for p, v in runs.items() if "ms" in v}
        top = max(timed.values(), key=lambda v: v["run_ms"])
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(v["launches"] for v in runs.values()),
            "max_abs_err": max([errs[k]] + [v["err"] for v in timed.values()]
                               + [v["err"] for v in variants.get(k, ())]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound"][0], "bound_by": top["bound"][1],
            "library_ms": None,
            "paths": {p: {"launches": v["launches"],
                          "run_ms": v["run_ms"]} | (
                {"shape": v["shape"], "plan": v.get("plan"), "ms": v["ms"],
                 "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                 "bound_by": v["bound"][1]} if p in timed else {})
                for p, v in runs.items()},
            "variants": [{"variant": v["variant"], "shape": v["shape"],
                          "ms": v["ms"], "plain_ms": v["plain_ms"],
                          "bound_ms": v["bound"][0],
                          "bound_by": v["bound"][1]}
                         for v in variants.get(k, ())]})
    # the time each kernel spends above its bound, summed over the main
    # paths: launches in the path's run x (time - bound) at its largest
    # launch; the order in which redesigning the kernels pays most
    gap = {k["name"]: sum(v["launches"] * (v["ms"] - v["bound_ms"])
                          for v in k["paths"].values() if "ms" in v)
           for k in kernels}
    for k in kernels:
        for p, v in k["paths"].items():
            if (k["name"], p) in FIRST_DESIGN_MS and "ms" in v:
                print(f"{k['name']} at {p} ({v['shape']}): {v['ms']:.3f} ms, "
                      f"first design {FIRST_DESIGN_MS[(k['name'], p)]:.3f} "
                      f"ms (recorded in PERF.md, not this run), bound "
                      f"{v['bound_ms']:.4f} ms, {v['launches']} launches")
        for v in k["variants"]:
            print(f"{k['name']} {v['variant']} ({v['shape']}): "
                  f"{v['ms']:.3f} ms vs plain {v['plain_ms']:.1f} ms, bound "
                  f"{v['bound_ms']:.4f} ms ({v['bound_by']})")
    print("time above the bound, launches x (ms - bound_ms) over the main "
          "paths: " + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              gap.items(), key=lambda kv: -kv[1])))
    print(f"total: {time.perf_counter() - t_start:.1f} s of command time; "
          f"no module of claragenomicsanalysis_tpu and no jax loaded")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------- measurement modes
# Run by hand on the card; the smoke (no arguments) runs none of them.
#
#   python3 chip_smoke.py --nwtb-split
#     Where B5's time goes: forward pass, end cell and traceback, and the
#     row's own parts (setup, pass 1, scan, pass 2, the next row's facts,
#     sync and copy), timed with clock64() stamps.  It writes stamped copies
#     of csrc/poa_nwtb.cuh and csrc/poa_nwtb.cu into build/nwtb_split/
#     (string edits at named anchors; an edit to those sources that moves
#     an anchor makes it raise), compiles them, and runs B5 on the graph-NW
#     inputs of the last add of a lockstep run at the deep, correction and
#     MSA shapes (this script's data and seed), in its plan's variant and
#     in the other one.  Per shape it prints each variant's time, the
#     cycles of each part per window, the cycles a row and a walk step, and
#     how many ranks back the preds lie.  (A stamped kernel runs a little
#     slower than the kernel itself.)
#
#   python3 chip_smoke.py --window-split
#     Where B10's time goes: csrc/poa_window.cu built with CGA_WINDOW_SPLIT
#     (thread 0 of each window sums the SM cycles of setup, topsort, the
#     graph NW's forward pass, end cell and walk, the add, the final
#     topsort, the consensus and the MSA) into build/window_split/, run at
#     the window route's first launch of the correction, MSA and deep
#     shapes, in its plan and in the other one; outputs checked equal to
#     the kernel's.  Per shape and plan it prints the stamped time, each
#     phase's cycles a window and share, and the cycles of a graph-NW row,
#     an add and a topsort.
#
#   python3 chip_smoke.py --add-split
#     Where B6's time goes: csrc/poa_add.cu built with CGA_ADD_SPLIT (lane
#     0 of each window sums the SM cycles of the entry scan, the node
#     choice, the clique update, the edge insert and the paths row, and
#     counts the entries scanned, the bases consumed and the nodes made)
#     into build/add_split/, run at B6's last lockstep launch of the first
#     launch of windows of the correction, deep and MSA shapes; outputs
#     checked equal to the kernel's.  Per shape it prints the kernel's and
#     the stamped kernel's time, each part's cycles a window and share, and
#     the cycles a consumed base.
#
#   python3 chip_smoke.py --topsort-split
#     Where B7's time goes: csrc/poa_topsort.cu built with CGA_TOPSORT_SPLIT
#     (lane 0 of each window records the sweeps run, ordered with their
#     confirming sweeps and Jacobi, and the SM cycles of the visit order, the
#     sweeps and the rank) into build/topsort_split/, run at B7's last
#     lockstep launch of the first launch of windows of the correction, deep
#     and MSA shapes; outputs checked equal to the kernel's.  Per shape it
#     prints the kernel's and the stamped kernel's time, the active nodes
#     and sweeps a window, each part's cycles a window and share, the cycles
#     a sweep and the rank's cycles an active node.
#
#   python3 chip_smoke.py --finish-split
#     Where B8's and B9's time goes: csrc/poa_consensus.cu built with
#     CGA_CONSENSUS_SPLIT into build/consensus_split/ and csrc/poa_msa.cu
#     with CGA_MSA_SPLIT into build/msa_split/, one nvcc each, together
#     (lane 0 of each window records the SM cycles of B8's table pass,
#     score sweeps, end node, walk back and writes, with its sweeps and
#     Jacobi sweeps; of B9's gathers, column chain, max and rows, with its
#     ranks and gathers), run at B8's last lockstep launch of the first
#     launch of windows of the correction, deep and MSA shapes and B9's at
#     the MSA shape; outputs checked equal to the kernel's.  Per launch it
#     prints the kernel's and the stamped kernel's time, each part's cycles
#     a window and share, and the sweeps or the ranks a window.
#
#   python3 chip_smoke.py --map-profile [OUT]
#     Where the map main path's time goes inside its stages: phase 20's
#     100 Mbp run (after a warm-up) under torch.profiler, its ops by device
#     time, then again under cProfile, its host functions by own and
#     cumulative time.  Prints the heads of the tables and writes them whole
#     to OUT (default build/map_profile.txt).
#
#   python3 chip_smoke.py --turns PARENT_DIR
#     B1 (nw_diag), B2 (tb_decode, both layouts), B3 (nw_row), B4 (myers),
#     B5 (poa_nwtb), B6 (poa_add), B7 (poa_topsort), B8 (poa_consensus), B9
#     (poa_msa) and B10 (poa_window) of this checkout against the same
#     kernels built from
#     another checkout (the parent commit, unpacked with git archive), on
#     identical inputs, each in its plan: B1, B3, B4 and B2 (the diag
#     layout on B1's traceback, the row one on B3's) on 449 pairs of
#     10,000-base queries at r = 72 (the ukkonen and ukkonen_row paths'
#     largest launch), B2 also at a myers base case (133,138 pairs of 32 x
#     32 at r = 32); B7, B5, B6 and B8 at the last launch of a lockstep run
#     at the correction, deep and MSA shapes, B9 at the MSA shape's (B6 from
#     the same state each launch, the copy untimed); B10 at the window
#     route's first launch at those shapes.  Launchers whose arguments both
#     builds share run through the port's wrappers (turns_via); B8 and B9
#     are called at each build's own arguments (TURNS_PARENT_SIGNATURES).
#     Both builds' outputs are checked equal, then each kernel is timed
#     parent, this, this, parent, TURNS_ROUNDS times,
#     TURNS_REPS launches a sample; the medians print with the card's name
#     and power limit.

def map_profile_main(out: str) -> int:
    """``--map-profile [OUT]``: phase 20's run under torch.profiler and
    cProfile, the whole tables written to ``out``."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from claragenomicsanalysis_tpu_torch.core.config import MapperConfig
    from claragenomicsanalysis_tpu_torch.models import mapper
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    parser, _ = map_reads(5_000_000, 10_000, 10_000, 11)
    cfg = MapperConfig()

    def run():
        res = mapper.map_all_vs_all(parser, cfg, device="cuda")
        torch.cuda.synchronize()
        return res

    run()
    t0 = time.perf_counter()
    run()
    print(f"map main path, unprofiled: {time.perf_counter() - t0:.3f} s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = sum(e.self_device_time_total for e in ka) / 1e3
    by_dev = ka.table(sort_by="self_device_time_total", row_limit=40)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=40)
    pr = cProfile.Profile()
    pr.enable()
    t0 = time.perf_counter()
    run()
    wall_c = time.perf_counter() - t0
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(40)
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(40)
    head = (f"torch.profiler: wall {wall:.3f} s, ops' device time "
            f"{dev:.3f} ms (busy share {dev / 1e3 / wall:.4f})")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write("\n\n".join([head, by_dev, by_cpu,
                              f"cProfile: wall {wall_c:.3f} s",
                              buf.getvalue()]))
    print(head)
    print("\n".join(by_dev.splitlines()[:30]))
    print(f"cProfile: wall {wall_c:.3f} s")
    print("\n".join(buf.getvalue().splitlines()[:60]))
    return 0


#: stamps added to csrc/poa_nwtb.cuh: per window clk[0..3] the starts of
#: the forward pass, the end cell, the walk and its end, clk[4] the walk's
#: steps, clk[5..10] the row's parts summed over its rows
SPLIT_HEADER_EDITS = [
    ("template <typename Word, bool kLdg>\nstruct Window {\n",
     "__device__ long long* g_clk;\ntemplate <typename Word, bool kLdg>\n"
     "struct Window {\n  long long* clk;\n"),
    ("  for (int r = 0; r < w.nce; ++r) {\n    const int ri = r + 1;",
     "  if (gt == 0) w.clk[0] = clock64();\n"
     "  long long a1 = 0, a2 = 0, a3 = 0, a4 = 0, a5 = 0, a6 = 0;\n"
     "  for (int r = 0; r < w.nce; ++r) {\n"
     "    const long long ta = clock64();\n    const int ri = r + 1;"),
    ("    // pass 1: the thread's running max of vals - j*g",
     "    a6 += clock64() - ta;\n"
     "    // pass 1: the thread's running max of vals - j*g"),
    ("    int run2 = group_prefix_max<kWarp>(run, wtot);",
     "    const long long tb = clock64();\n    a1 += tb - ta;\n"
     "    int run2 = group_prefix_max<kWarp>(run, wtot);\n"
     "    const long long tc = clock64();\n    a2 += tc - tb;"),
    ("    flight_land(w, d, r + 1, f1, rk, nxt, gt, gn);",
     "    const long long td = clock64();\n    a3 += td - tc;\n"
     "    flight_land(w, d, r + 1, f1, rk, nxt, gt, gn);"),
    ("    group_sync<kWarp>();  // the row and the next row's facts are "
     "complete",
     "    const long long te = clock64();\n    a4 += te - td;\n"
     "    group_sync<kWarp>();"),
    ("      for (int e = gt; e <= hi - lo; e += gn) out[lo + e] = src[e];\n"
     "    }\n  }",
     "      for (int e = gt; e <= hi - lo; e += gn) out[lo + e] = src[e];\n"
     "    }\n    a5 += clock64() - te;\n  }\n"
     "  if (gt == 0) {\n    w.clk[1] = clock64();\n    w.clk[5] = a6;\n"
     "    w.clk[6] = a1 - a6;\n    w.clk[7] = a2;\n    w.clk[8] = a3;\n"
     "    w.clk[9] = a4;\n    w.clk[10] = a5;\n  }"),
    ("  if (gt != 0) return;\n", "  if (gt != 0) return;\n"
     "  w.clk[2] = clock64();\n"),
    ("  *k0_out = k;\n}", "  *k0_out = k;\n  w.clk[3] = clock64();\n"
     "  w.clk[4] = TL - k;\n}"),
]
#: and to csrc/poa_nwtb.cu: each window's clk, and the launcher's names
SPLIT_EDITS = [
    ("  win.nce = min(max(win.nc, 0), d.N);",
     "  win.nce = min(max(win.nc, 0), d.N);\n  win.clk = g_clk + 16 * w;"),
    ('extern "C" int cga_poa_nwtb(',
     'extern "C" int set_clk(void* p) {\n'
     '  return (int)cudaMemcpyToSymbol(g_clk, &p, sizeof(p));\n}\n'
     'extern "C" int stamped_poa_nwtb('),
]


def split_stamped(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed: {old!r}")
        src = src.replace(old, new)
    return src


def split_build() -> ctypes.CDLL:
    from claragenomicsanalysis_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", "nwtb_split")
    os.makedirs(out, exist_ok=True)
    for name, edits in (("poa_nwtb.cuh", SPLIT_HEADER_EDITS),
                        ("poa_nwtb.cu", SPLIT_EDITS)):
        with open(os.path.join(out, name), "w") as f:
            src = open(os.path.join(_build.CSRC, name)).read()
            f.write(split_stamped(src, edits))
    so = os.path.join(out, "libsplit.so")
    # the stamped .cu finds the stamped header beside it first
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-shared", "-o", so, os.path.join(out, "poa_nwtb.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.stamped_poa_nwtb.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.set_clk.argtypes = [ctypes.c_void_p]
    return lib


def split_measure(lib, tag: str, cfg: dict, n: int, blen: int, edits: int,
                  banded: bool) -> None:
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.ops import poa_nwtb, poa_window
    calls = []
    orig = poa_window.graph_nw_traceback

    def spy(*args):
        calls.append(args)
        return orig(*args)

    bs = BatchSize(**cfg)
    S, L = bs.max_sequences_per_poa, bs.padded_seq
    _, _, arrays = poa_window_arrays(n, blen, S, edits, L,
                                        SEED + 20 + S)
    poa_window.graph_nw_traceback = spy
    try:
        poa_window.run_windows(bs, PoaScores(), banded,
                               *(torch.as_tensor(a).cuda() for a in arrays))
    finally:
        poa_window.graph_nw_traceback = orig
    args = calls[-1]
    seq, order, rank, npred, base, nsucc, pred, slen, nc, alive, sc, bw = args
    W, L = seq.shape
    N, P = pred.shape[1], pred.shape[2]
    dev = seq.device
    bufs = [t.contiguous() for t in (seq, order, rank, npred, base, nsucc,
                                     pred, slen, nc)]
    bufs.append(alive.to(torch.int32))
    bufs.append(torch.empty((W, N + 1, L + 1), dtype=torch.int32, device=dev))
    bufs += [torch.empty((W, N + L), dtype=torch.int32, device=dev)
             for _ in range(2)]
    bufs += [torch.empty(W, dtype=torch.int32, device=dev) for _ in range(2)]
    live = alive.cpu().numpy()
    # B5 as it stands, in its plan's variant and in the other one
    W_, N_, P_ = W, N, P
    plan = poa_nwtb.nwtb_plan(W_, N_, P_, L, bw)
    other = "block" if plan[0] == "warp" else "warp"
    clk16 = torch.zeros((W, 16), dtype=torch.int64, device=dev)
    if lib.set_clk(clk16.data_ptr()):
        raise RuntimeError("set_clk failed")
    for variant in (plan[0], other):
        with nwtb_forced(variant, poa_nwtb.RING_ROWS):
            v, threads, ring = poa_nwtb.nwtb_plan(W_, N_, P_, L, bw)
        if v != variant:
            continue  # rows too wide for a warp
        clk16.zero_()

        def go2():
            err = lib.stamped_poa_nwtb(
                *(t.data_ptr() for t in bufs[:15]), W, N, P, L,
                sc.match_score, sc.mismatch_score, sc.gap_score, bw,
                int(v == "block"), threads, ring,
                poa_nwtb.ring_width(L, bw), 4,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"stamped_poa_nwtb: CUDA error {err}")

        ms2, _ = cuda_ms(go2, 5)
        c = clk16.cpu().numpy().astype(np.float64)
        ok = alive.cpu().numpy() & (c[:, 3] > 0)
        rows_ = nc.cpu().numpy()[ok]
        fwd, end, walk = (c[ok, 1] - c[ok, 0], c[ok, 2] - c[ok, 1],
                          c[ok, 3] - c[ok, 2])
        tot = (fwd + end + walk).sum()
        parts = c[ok, 5:11].sum(0) / rows_.sum()
        print(f"{tag}: B5 now, {v} ({threads} threads, ring {ring}"
              f"{', the plan' if v == plan[0] else ''}): {ms2:.3f} ms "
              f"stamped; cycles a window: forward {fwd.mean():.0f} "
              f"({fwd.sum() / tot:.3f}), end cell {end.mean():.0f}, walk "
              f"{walk.mean():.0f} ({walk.sum() / tot:.3f}); "
              f"{(fwd / rows_).mean():.1f} a row (setup {parts[0]:.0f}, "
              f"pass 1 {parts[1]:.0f}, scan {parts[2]:.0f}, pass 2 "
              f"{parts[3]:.0f}, next row's facts {parts[4]:.0f}, sync and "
              f"copy {parts[5]:.0f}), {(walk / c[ok, 4]).mean():.1f} a walk "
              f"step")
    rk, od, pr, npr = (t.cpu().numpy() for t in (rank, order, pred, npred))
    back = []
    for w in np.flatnonzero(live)[:64]:
        for r in range(int(nc[w])):
            u = od[w, r]
            back += [r - rk[w, q] for q in pr[w, u, :min(npr[w, u], P)]
                     if 0 <= q < N]
    back = np.array(back)
    print(f"{tag}: preds this many ranks back (64 windows, {len(back)} "
          f"preds): " + ", ".join(f"<= {k}: {np.mean(back <= k):.4f}"
                                  for k in (1, 2, 4, 8)) +
          f"; the most {back.max()}")


def nwtb_split_main() -> int:
    """``--nwtb-split``: split_measure at the deep, correction and MSA
    shapes (this script's data and seed)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = split_build()
    split_measure(lib, "deep", POA_DEEP, N_POA_DEEP, 256, 12, True)
    split_measure(lib, "correction", POA_CORR, N_POA, 128, 6, False)
    split_measure(lib, "msa", POA_MSA, N_POA, 100, 5, False)
    return 0


#: the phases of B10's split build (csrc/poa_window.cu built with
#: CGA_WINDOW_SPLIT): thread 0 of each window sums the SM cycles of each
#: into slots 0-8; slot 9 holds the sequences added, slot 10 the graph-NW
#: rows
WINDOW_SPLIT_PHASES = ("setup", "topsort", "NW forward", "NW end cell",
                       "walk", "add", "final topsort", "consensus", "MSA")


def window_split_build() -> ctypes.CDLL:
    """csrc/poa_window.cu built with CGA_WINDOW_SPLIT into
    build/window_split/: the same launcher, which also writes each
    window's record."""
    from claragenomicsanalysis_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", "window_split")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libwindow_split.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DCGA_WINDOW_SPLIT",
                    "-I", str(_build.CSRC), "-shared", "-o", so,
                    str(_build.CSRC / "poa_window.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.cga_poa_window.argtypes = list(_build.SIGNATURES["cga_poa_window"])
    lib.cga_poa_window.restype = ctypes.c_int
    lib.cga_poa_window_split_set.argtypes = [ctypes.c_void_p] * 2
    lib.cga_poa_window_split_set.restype = ctypes.c_int
    lib.cga_error_string = _build.load().cga_error_string
    return lib


def window_split_measure(lib, tag: str, cfg: dict, n: int, blen: int,
                         edits: int, banded: bool, msa: bool) -> None:
    """B10's split at the window route's first launch of this script's
    windows of a shape, in its plan and in the other one: the stamped
    kernel's time, each phase's cycles a window and share, the cycles of
    a graph-NW row and of an add; outputs checked equal to the kernel's."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.models import poa
    from claragenomicsanalysis_tpu_torch.ops import _build, poa_window
    bs = BatchSize(**cfg)
    S, L = bs.max_sequences_per_poa, bs.padded_seq
    W = len(poa.launch_chunks(n, bs, msa, kernel="window")[0])
    _, _, arrays = poa_window_arrays(W, blen, S, edits, L, SEED + 20 + S)
    args = [torch.as_tensor(a).cuda() for a in arrays]
    sc, bw = PoaScores(), bs.band_width if banded else 0
    want = poa_window.poa_window(*args, bs, sc, banded, msa)
    plan = poa_window.window_plan(W, bs, bw)
    split = torch.zeros((W, 16), dtype=torch.int64, device="cuda")
    marks = torch.zeros(2 * W * 1024 + 256, dtype=torch.int64, device="cuda")
    if lib.cga_poa_window_split_set(split.data_ptr(), marks.data_ptr()):
        raise RuntimeError("cga_poa_window_split_set failed")
    real = _build.load
    for variant in (plan[0], "block" if plan[0] == "warp" else "warp"):
        with window_forced(variant, poa_window.RING_ROWS):
            got_plan = poa_window.window_plan(W, bs, bw)
            _build.load = lambda: lib
            try:
                ms, got = cuda_ms(
                    lambda: poa_window.poa_window(*args, bs, sc, banded, msa),
                    3)
            finally:
                _build.load = real
        check(maxdiff(got, want) == 0, f"{tag}: the split build of B10 "
              f"disagrees with the kernel")
        c = split.cpu().numpy().astype(np.float64)
        phases = c[:, :len(WINDOW_SPLIT_PHASES)]
        tot = phases.sum()
        per = phases.mean(0)
        adds, rows = c[:, 9].sum(), c[:, 10].sum()
        print(f"{tag}: W={W} N={bs.padded_nodes} L={L} P="
              f"{bs.max_pred_per_node} S={S}{' msa' * msa}{' banded' * banded}"
              f", plan {got_plan}{' (the plan)' if variant == plan[0] else ''}"
              f": {ms:.3f} ms stamped; cycles a window "
              f"{phases.sum(1).mean():.0f}: " + ", ".join(
                  f"{k} {v:.0f} ({c_ / tot:.3f})" for k, v, c_ in zip(
                      WINDOW_SPLIT_PHASES, per, phases.sum(0))) +
              f"; {c[:, 2].sum() / max(rows, 1):.1f} cycles a graph-NW row "
              f"({rows / W:.1f} rows a window), "
              f"{c[:, 5].sum() / max(adds, 1):.1f} an add, "
              f"{c[:, 1].sum() / max(adds, 1):.1f} a topsort "
              f"({adds / W:.2f} sequences added a window)")


def window_split_main() -> int:
    """``--window-split``: window_split_measure at the correction, MSA and
    deep shapes (this script's data and seed)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = window_split_build()
    window_split_measure(lib, "correction", POA_CORR, N_POA, 128, 6, False,
                         False)
    window_split_measure(lib, "msa", POA_MSA, N_POA, 100, 5, False, True)
    window_split_measure(lib, "deep", POA_DEEP, N_POA_DEEP, 256, 12, True,
                         False)
    return 0


#: the parts of B6's split build (csrc/poa_add.cu built with CGA_ADD_SPLIT):
#: each window sums the SM cycles of each into slots 0-4; slots 5-7 hold the
#: path entries scanned, the bases consumed and the nodes made
ADD_SPLIT_PARTS = ("entry scan", "node choice", "clique update",
                   "edge insert", "paths row")


def add_split_build() -> ctypes.CDLL:
    """csrc/poa_add.cu built with CGA_ADD_SPLIT into build/add_split/: the
    same launcher, which also adds each window's record."""
    from claragenomicsanalysis_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", "add_split")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libadd_split.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DCGA_ADD_SPLIT",
                    "-I", str(_build.CSRC), "-shared", "-o", so,
                    str(_build.CSRC / "poa_add.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.cga_poa_add.argtypes = list(_build.SIGNATURES["cga_poa_add"])
    lib.cga_poa_add.restype = ctypes.c_int
    lib.cga_poa_add_split_set.argtypes = [ctypes.c_void_p]
    lib.cga_poa_add_split_set.restype = ctypes.c_int
    lib.cga_error_string = _build.load().cga_error_string
    return lib


def last_add_args(cfg: dict, n: int, blen: int, edits: int, banded: bool,
                  msa: bool) -> tuple:
    """The inputs of B6's last launch of a lockstep run of the first
    launch of windows of a main path's shape (this script's data and seed,
    as phases 12-14 make it)."""
    return last_lockstep_args("add_alignment", cfg, n, blen, edits, banded,
                              msa)


def last_lockstep_args(name: str, cfg: dict, n: int, blen: int, edits: int,
                       banded: bool, msa: bool) -> tuple:
    """The inputs of the last call of ``ops.poa_window.<name>`` in a
    lockstep run of the first launch of windows of a main path's shape."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.models import poa
    from claragenomicsanalysis_tpu_torch.ops import poa_window
    bs = BatchSize(**cfg)
    S, L = bs.max_sequences_per_poa, bs.padded_seq
    W = len(poa.launch_chunks(n, bs, msa)[0])
    _, _, arrays = poa_window_arrays(n, blen, S, edits, L, SEED + 20 + S + msa)
    calls, orig = [], getattr(poa_window, name)

    def spy(*args):
        calls.append(args)
        return orig(*args)

    setattr(poa_window, name, spy)
    try:
        poa_window.run_windows(bs, PoaScores(), banded,
                               *(torch.as_tensor(a[:W]).cuda()
                                 for a in arrays), msa)
    finally:
        setattr(poa_window, name, orig)
    return calls[-1]


def add_split_measure(lib, tag: str, args: tuple) -> None:
    """B6's split at one launch: the stamped kernel's time beside the
    kernel's, each part's cycles a window and share, the entries scanned
    and the bases consumed a window, and the cycles a consumed base;
    outputs checked equal to the kernel's."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import _build, poa_add
    state = args[0]
    W, N, P = state.pred.shape
    A, L = state.alig.shape[2], args[3].shape[1]
    act = args[6].cpu().numpy()
    ms_k, want = cuda_ms(lambda: poa_add.add_alignment(*args), 5)
    split = torch.zeros((W, 8), dtype=torch.int64, device="cuda")
    if lib.cga_poa_add_split_set(split.data_ptr()):
        raise RuntimeError("cga_poa_add_split_set failed")
    real = _build.load
    _build.load = lambda: lib
    try:
        got = poa_add.add_alignment(*args)
        torch.cuda.synchronize()
        c = split.cpu().numpy().astype(np.float64)[act]
        ms, _ = cuda_ms(lambda: poa_add.add_alignment(*args), 3)
    finally:
        _build.load = real
    check(maxdiff(got, want) == 0, f"{tag}: the split build of B6 disagrees "
          f"with the kernel")
    parts = c[:, :len(ADD_SPLIT_PARTS)]
    tot = parts.sum()
    scanned, taken, made = (c[:, k].sum() for k in (5, 6, 7))
    print(f"{tag}: B6 at W={W} N={N} L={L} P={P} A={A}"
          f"{' with paths' * (state.paths is not None)} ({int(act.sum())} "
          f"windows active): kernel {ms_k:.3f} ms, stamped {ms:.3f} ms; "
          f"cycles a window {parts.sum(1).mean():.0f}: " + ", ".join(
              f"{k} {v:.0f} ({s_ / tot:.3f})" for k, v, s_ in zip(
                  ADD_SPLIT_PARTS, parts.mean(0), parts.sum(0)))
          + f"; a window scans {scanned / len(c):.1f} entries and consumes "
          f"{taken / len(c):.1f} bases ({made / len(c):.1f} new nodes): "
          f"{tot / max(taken, 1):.0f} cycles a consumed base")


def add_split_main() -> int:
    """``--add-split``: add_split_measure at B6's last lockstep launch of
    the correction, deep and MSA shapes (this script's data and seed)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = add_split_build()
    for tag, cfg, n, blen, edits, banded, msa in POA_SHAPES:
        add_split_measure(lib, tag, last_add_args(cfg, n, blen, edits,
                                                  banded, msa))
    return 0


TOPSORT_SPLIT_PARTS = ("visit order", "sweeps", "rank")


def topsort_split_build() -> ctypes.CDLL:
    """csrc/poa_topsort.cu built with CGA_TOPSORT_SPLIT into
    build/topsort_split/: the same launcher, which also writes each
    window's record."""
    from claragenomicsanalysis_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", "topsort_split")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libtopsort_split.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    "-DCGA_TOPSORT_SPLIT", "-I", str(_build.CSRC), "-shared",
                    "-o", so, str(_build.CSRC / "poa_topsort.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.cga_poa_topsort.argtypes = list(
        _build.SIGNATURES["cga_poa_topsort"])
    lib.cga_poa_topsort.restype = ctypes.c_int
    lib.cga_poa_topsort_split_set.argtypes = [ctypes.c_void_p]
    lib.cga_poa_topsort_split_set.restype = ctypes.c_int
    lib.cga_error_string = _build.load().cga_error_string
    return lib


def topsort_launch_ms(lib, args: tuple, reps: int = 20) -> float:
    """Mean milliseconds of B7's launcher alone on ``args`` (outputs
    allocated once, ``reps`` launches back to back between two events), so
    that the wrapper's host time does not hide a short kernel."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import poa_topsort
    level, npred, pred, nc, nc_pre = (a.contiguous() for a in args)
    W, N, P = pred.shape
    variant, windows = poa_topsort.topsort_plan(N)
    outs = [torch.empty_like(level) for _ in range(3)] + [
        torch.empty(W, dtype=torch.int32, device="cuda")]
    scratch = torch.empty(W * poa_topsort.topsort_table_bytes(N) // 4
                          if variant == "warp-device" else 1,
                          dtype=torch.int32, device="cuda")

    def launch():
        turns_checked("poa_topsort", lib.cga_poa_topsort(
            *turns_ptrs(level, npred, pred, nc, nc_pre, *outs),
            scratch.data_ptr() if variant == "warp-device" else None, W, N,
            P, windows, turns_stream()))

    launch()
    return cuda_ms(launch, reps)[0]


def topsort_split_measure(lib, tag: str, args: tuple,
                          sm_mhz: float) -> None:
    """B7's split at one launch: the kernel's time (the wrapper's, and the
    launcher's alone) beside the stamped kernel's; per window the sweeps
    run (ordered, confirming and Jacobi), the cycles of the visit order,
    the sweeps and the rank and their shares; outputs checked equal to the
    kernel's."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import _build, poa_topsort
    W, N, P = args[2].shape
    ms_k, want = cuda_ms(lambda: poa_topsort.topsort(*args), 5)
    ms_alone = topsort_launch_ms(_build.load(), args)
    split = torch.zeros((W, 8), dtype=torch.int64, device="cuda")
    if lib.cga_poa_topsort_split_set(split.data_ptr()):
        raise RuntimeError("cga_poa_topsort_split_set failed")
    real = _build.load
    _build.load = lambda: lib
    try:
        got = poa_topsort.topsort(*args)
        torch.cuda.synchronize()
        c = split.cpu().numpy().astype(np.float64)
        ms, _ = cuda_ms(lambda: poa_topsort.topsort(*args), 3)
    finally:
        _build.load = real
    check(maxdiff(got, want) == 0, f"{tag}: the split build of B7 disagrees "
          f"with the kernel")
    parts = c[:, 1:4]
    tot = parts.sum()
    sweeps, jacobi, nodes, ordered = c[:, 0], c[:, 4], c[:, 5], c[:, 6]
    print(f"{tag}: B7 at W={W} N={N} P={P}: kernel {ms_k:.3f} ms through "
          f"its wrapper, {ms_alone:.4f} ms launched alone (= "
          f"{ms_alone * 1e3 * sm_mhz:.0f} SM cycles), stamped {ms:.3f} ms; "
          f"the longest window {parts.sum(1).max():.0f} cycles; a "
          f"window has {nodes.mean():.1f} active nodes (max "
          f"{int(nodes.max())}) and runs {sweeps.mean():.2f} sweeps (max "
          f"{int(sweeps.max())}; ordered {ordered.mean():.2f}, Jacobi "
          f"{jacobi.mean():.2f}, {int((jacobi > 0).sum())} windows with "
          f"Jacobi sweeps); cycles a window {parts.sum(1).mean():.0f}: "
          + ", ".join(f"{k} {v:.0f} ({s_ / max(tot, 1):.3f})" for k, v, s_
                      in zip(TOPSORT_SPLIT_PARTS, parts.mean(0),
                             parts.sum(0)))
          + f"; {parts[:, 1].sum() / max(sweeps.sum(), 1):.0f} cycles a "
          f"sweep, {parts[:, 2].sum() / max(nodes.sum(), 1):.0f} rank "
          f"cycles an active node")


def topsort_split_main() -> int:
    """``--topsort-split``: topsort_split_measure at B7's last lockstep
    launch of the first launch of windows of the correction, deep and MSA
    shapes (this script's data and seed)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    lib = topsort_split_build()
    for tag, cfg, n, blen, edits, banded, msa in POA_SHAPES:
        topsort_split_measure(lib, tag, last_lockstep_args(
            "topsort", cfg, n, blen, edits, banded, msa), sm_mhz)
    return 0


#: the parts of B8's split build (csrc/poa_consensus.cu built with
#: CGA_CONSENSUS_SPLIT): each window writes the SM cycles of each into slots
#: 0-4; slot 5 holds the sweeps run, 6 the Jacobi sweeps among them, 7 the
#: active nodes
CONSENSUS_SPLIT_PARTS = ("table pass", "score sweeps", "end node",
                         "walk back", "writes")
#: and of B9's (csrc/poa_msa.cu built with CGA_MSA_SPLIT): slots 0-3; slot
#: 4 holds the ranks walked, 5 the ranks that gave a clique its column, 6
#: the gathers of rank lists
MSA_SPLIT_PARTS = ("gather", "column chain", "max", "rows")


def finish_split_build() -> dict:
    """csrc/poa_consensus.cu built with CGA_CONSENSUS_SPLIT into
    build/consensus_split/ and csrc/poa_msa.cu with CGA_MSA_SPLIT into
    build/msa_split/, one nvcc each, started together: kernel name -> its
    library (the same launcher, which also writes each window's record)."""
    from claragenomicsanalysis_tpu_torch.ops import _build
    builds = []
    for name, flag in (("poa_consensus", "-DCGA_CONSENSUS_SPLIT"),
                       ("poa_msa", "-DCGA_MSA_SPLIT")):
        out = os.path.join(ROOT, "build", name[4:] + "_split")
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, f"lib{name[4:]}_split.so")
        builds.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, flag, "-I", str(_build.CSRC),
             "-shared", "-o", so, str(_build.CSRC / f"{name}.cu")])))
    libs = {}
    for name, so, proc in builds:
        check(proc.wait() == 0, f"the split build of {name} failed")
        lib = ctypes.CDLL(so)
        launcher = getattr(lib, f"cga_{name}")
        launcher.argtypes = list(_build.SIGNATURES[f"cga_{name}"])
        launcher.restype = ctypes.c_int
        setter = getattr(lib, f"cga_{name}_split_set")
        setter.argtypes = [ctypes.c_void_p]
        setter.restype = ctypes.c_int
        lib.cga_error_string = _build.load().cga_error_string
        libs[name] = lib
    return libs


def finish_split_measure(lib, k: str, tag: str, args: tuple,
                         sm_mhz: float) -> None:
    """B8's (``k`` "poa_consensus") or B9's ("poa_msa") split at one
    launch: the kernel's time through its wrapper beside the stamped
    kernel's; per window each part's SM cycles and share, and the sweeps
    (B8) or the ranks and gathers (B9); outputs checked equal to the
    kernel's."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import _build, poa_window
    fn = getattr(poa_window, POA_STEPS[k][0])
    ms_k, want = cuda_ms(lambda: fn(*args), 5)
    W = want[0].shape[0]
    split = torch.zeros((W, 8), dtype=torch.int64, device="cuda")
    if getattr(lib, f"cga_{k}_split_set")(split.data_ptr()):
        raise RuntimeError(f"cga_{k}_split_set failed")
    real = _build.load
    _build.load = lambda: lib
    try:
        got = fn(*args)
        torch.cuda.synchronize()
        c = split.cpu().numpy().astype(np.float64)
        ms, _ = cuda_ms(lambda: fn(*args), 3)
    finally:
        _build.load = real
    check(maxdiff(got, want) == 0, f"{tag}: the split build of {k} "
          f"disagrees with the kernel")
    names = CONSENSUS_SPLIT_PARTS if k == "poa_consensus" else MSA_SPLIT_PARTS
    parts = c[:, :len(names)]
    tot = max(parts.sum(), 1)
    N = args[1].shape[1] if k == "poa_consensus" else args[0].base.shape[1]
    head = (f"{tag}: {k} at W={W} N={N}: kernel {ms_k:.3f} ms through its "
            f"wrapper, stamped {ms:.3f} "
            f"ms (= {ms * 1e3 * sm_mhz:.0f} SM cycles); cycles a window "
            f"{parts.sum(1).mean():.0f} (the longest {parts.sum(1).max():.0f}"
            f"): " + ", ".join(f"{n} {v:.0f} ({s_ / tot:.3f})" for n, v, s_ in
                               zip(names, parts.mean(0), parts.sum(0))))
    if k == "poa_consensus":
        sweeps, jacobi, nodes = c[:, 5], c[:, 6], c[:, 7]
        length = want[2].cpu().numpy().astype(np.float64)
        print(f"{head}; {nodes.mean():.1f} active nodes a window, "
              f"{sweeps.mean():.2f} sweeps (max {int(sweeps.max())}; Jacobi "
              f"{jacobi.mean():.2f}, {int((jacobi > 0).sum())} windows with "
              f"Jacobi sweeps), "
              f"{parts[:, 1].sum() / max(sweeps.sum(), 1):.0f} cycles a "
              f"sweep, {parts[:, 3].sum() / max(length.sum(), 1):.1f} walk "
              f"cycles a consensus base ({length.mean():.1f} a window)")
    else:
        ranks, done, gathers = c[:, 4], c[:, 5], c[:, 6]
        print(f"{head}; {ranks.mean():.1f} ranks a window, "
              f"{done.mean():.1f} of them giving a clique its column, "
              f"{gathers.mean():.2f} gathers; "
              f"{(parts[:, 0] + parts[:, 1]).sum() / max(ranks.sum(), 1):.0f}"
              f" gather and chain cycles a rank")


def finish_split_main() -> int:
    """``--finish-split``: finish_split_measure for B8 at its last
    lockstep launch of the first launch of windows of the correction, deep
    and MSA shapes, and for B9 at the MSA shape's (this script's data and
    seed)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    libs = finish_split_build()
    for tag, cfg, n, blen, edits, banded, msa in POA_SHAPES:
        finish_split_measure(libs["poa_consensus"], "poa_consensus", tag,
                             last_lockstep_args("consensus", cfg, n, blen,
                                                edits, banded, msa), sm_mhz)
        if msa:
            finish_split_measure(libs["poa_msa"], "poa_msa", tag,
                                 last_lockstep_args("msa_rows", cfg, n, blen,
                                                    edits, banded, msa),
                                 sm_mhz)
    return 0


TURNS_ROUNDS, TURNS_REPS = 5, 5
#: the parent's launchers (before B8 and B9 took their plans)
_TP, _TI = ctypes.c_void_p, ctypes.c_int
TURNS_PARENT_SIGNATURES = {
    "cga_nw_diag": (_TP,) * 7 + (_TI,) * 9 + (_TP,),
    "cga_tb_decode_diag": (_TP,) * 5 + (_TI,) * 8 + (_TP,),
    "cga_nw_row": (_TP,) * 7 + (_TI,) * 10 + (_TP,),
    "cga_tb_decode_row": (_TP,) * 5 + (_TI,) * 8 + (_TP,),
    "cga_myers": (_TP,) * 7 + (_TI,) * 5 + (_TP,),
    "cga_poa_topsort": (_TP,) * 10 + (_TI,) * 4 + (_TP,),
    "cga_poa_nwtb": (_TP,) * 15 + (_TI,) * 13 + (_TP,),
    "cga_poa_add": (_TP,) * 17 + (_TI,) * 8 + (_TP,),
    "cga_poa_consensus": (_TP,) * 11 + (_TI,) * 4 + (_TP,),
    "cga_poa_msa": (_TP,) * 10 + (_TI,) * 6 + (_TP,),
    "cga_poa_window": (_TP,) * 13 + (_TI,) * 18 + (_TP,),
}


def turns_parent_window_scratch(bs) -> int:
    """The parent's B10 slice of device scratch a window, in bytes: its
    phase tables held the first B8's 6N + NP + MC int32."""
    N, P, A = bs.padded_nodes, bs.max_pred_per_node, bs.max_aligned_per_node
    return 4 * (N * (8 + 2 * P + A) + 2 * (N + bs.padded_seq) + 6 * N + N * P
                + bs.max_consensus_size)


def turns_parent_lib(parent: str) -> ctypes.CDLL:
    import importlib.util
    path = os.path.join(parent, "claragenomicsanalysis_tpu_torch", "ops",
                        "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(mod.build()))
    for name, argtypes in TURNS_PARENT_SIGNATURES.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int
    lib.cga_error_string.argtypes = [ctypes.c_int]
    lib.cga_error_string.restype = ctypes.c_char_p
    return lib


def turns_ptrs(*ts):
    return [t.data_ptr() for t in ts]


def turns_stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def turns_checked(name, err):
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def turns_via(lib, fn):
    """``fn`` (a wrapper call) run with ops._build.load giving ``lib``: a
    launcher whose signature both builds share, driven through the port."""
    from claragenomicsanalysis_tpu_torch.ops import _build

    def run():
        real = _build.load
        _build.load = lambda: lib
        try:
            return fn()
        finally:
            _build.load = real
    return run


def turns_banded_inputs(B=449, L=10_000, r=72, seed=SEED):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, L), dtype=np.int8)
    t = np.full((B, L + 8), -1, np.int8)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        s = q[b].copy()
        sub = rng.random(L) < 0.01
        s[sub] = (s[sub] + 1) % 4
        s = np.delete(s, rng.choice(L, 20, replace=False))
        s = np.insert(s, rng.choice(len(s), 24), rng.integers(0, 4, 24))
        t[b, :len(s)] = s
        tlen[b] = len(s)
    qlen = np.full(B, L, np.int32)
    return [torch.from_numpy(a).cuda() for a in (q, qlen, t, tlen)], r


def turns_decode_pair(cur, par, tag, tb, qlen, tlen, r, layout):
    """B2 of both builds on one traceback, both in this one's plan; outputs
    into buffers zeroed once (each launch writes the same words)."""
    import torch
    from claragenomicsanalysis_tpu_torch.ops import tb_decode
    R4, B, W = tb.shape
    TL = (tb_decode.path_slots(R4) if layout == "diag"
          else tb_decode.path_slots_row(R4, r))
    plan = tb_decode.tb_decode_plan(B, R4, W, layout)
    copy = 0 if plan[0] == "thread" else int(plan[0].split("-")[1])
    name = f"cga_tb_decode_{layout}"

    def bufs():
        return [torch.zeros((B, TL // 16), dtype=torch.int32, device="cuda"),
                torch.empty(B, dtype=torch.int32, device="cuda")]

    bc, bp = bufs(), bufs()

    def run_cur():
        turns_checked(name, getattr(cur, name)(
            *turns_ptrs(tb, qlen, tlen, *bc), B, R4, W, r, TL, copy,
            plan[1], plan[2], turns_stream()))
        return bc

    def run_par():
        turns_checked(name, getattr(par, name)(
            *turns_ptrs(tb, qlen, tlen, *bp), B, R4, W, r, TL, copy,
            plan[1], plan[2], turns_stream()))
        return bp

    return (f"B2 tb_decode ({layout}) {tag} B={B} R4={R4} W={W} (this: "
            f"{'/'.join(map(str, plan))})", run_cur, run_par, None)


def turns_banded_pairs(cur, par):
    """B1, B3, B4 and B2 (both layouts) on the ukkonen paths' largest
    launch, and B2 at a myers base case."""
    import numpy as np
    import torch
    from claragenomicsanalysis_tpu_torch.ops import myers, nw_diag, nw_row
    (q, qlen, t, tlen), r = turns_banded_inputs()
    B, Lq = q.shape
    Lt = t.shape[1]
    out = []

    def diag():
        return nw_diag.banded_nw_diag(q, qlen, t, tlen, r)

    def row():
        return nw_row.banded_nw_row(q, qlen, t, tlen, r)

    def bottom():
        return myers.myers_bottom_row(q, qlen, t, tlen)

    out.append((f"B1 nw_diag B={B} Lq={Lq} r={r} (this: "
                f"{nw_diag.nw_diag_plan(Lq, Lt, r)})", diag,
                turns_via(par, diag), None))
    out.append((f"B3 nw_row B={B} Lq={Lq} r={r} (this: "
                f"{nw_row.nw_row_plan(Lq, Lt, r)})", row,
                turns_via(par, row), None))
    out.append((f"B4 myers B={B} Lq={Lq} Lt={Lt}", bottom,
                turns_via(par, bottom), None))
    out.append(turns_decode_pair(cur, par, "ukkonen", diag()[1], qlen, tlen,
                                 r, "diag"))
    out.append(turns_decode_pair(cur, par, "ukkonen_row", row()[1], qlen,
                                 tlen, r, "row"))
    rng = np.random.default_rng(SEED)
    Bb = 133_138
    qb, tb_ = (torch.from_numpy(rng.integers(0, 4, (Bb, 32), dtype=np.int8))
               .cuda() for _ in range(2))
    ln = torch.full((Bb,), 32, dtype=torch.int32, device="cuda")
    out.append(turns_decode_pair(
        cur, par, "myers base case",
        nw_diag.banded_nw_diag(qb, ln, tb_, ln, 32)[1], ln, ln, 32, "diag"))
    return out


def turns_add_pair(cur, par, tag, args):
    """B6 of both builds at one launch, each from the same state: the
    state is copied into each build's buffers before every launch, outside
    the timed span."""
    import torch
    state, pn, pp, seq, weights, k0, act, max_nodes, seq_idx = args
    W, N, P = state.pred.shape
    A, L = state.alig.shape[2], seq.shape[1]
    S = 0 if state.paths is None else state.paths.shape[1]
    s_row = 0 if S == 0 else min(max(seq_idx, 0), S - 1)
    ins = [x.contiguous() for x in (pn, pp, seq, weights, k0)] + [
        act.to(torch.int32)]
    bc, bp = state.clone(), state.clone()

    def prep():
        for b in (bc, bp):
            for d, s_ in zip(b.tensors(), state.tensors()):
                d.copy_(s_)

    def launch(lib, buf):
        paths = buf.paths.data_ptr() if S else None
        turns_checked("poa_add", lib.cga_poa_add(
            *turns_ptrs(*ins, *buf[:10]), paths, W, N, P, A, L, S, s_row,
            max_nodes, turns_stream()))
        return buf.tensors()

    return (f"B6 poa_add {tag} W={W} N={N} P={P} A={A}",
            lambda: launch(cur, bc), lambda: launch(par, bp), prep)


def turns_poa_pairs(cur, par, tag, cfg, n, blen, edits, banded, msa=False):
    """B7, B5, B8 and (with ``msa``) B9 at the last launch of a lockstep
    run of these windows, B6 at the last launch of the lockstep run of
    their first launch of windows (last_add_args), and B10 at the window
    route's first launch of them."""
    import torch
    from claragenomicsanalysis_tpu_torch.core.config import (BatchSize,
                                                             PoaScores)
    from claragenomicsanalysis_tpu_torch.models import poa
    from claragenomicsanalysis_tpu_torch.ops import (poa_consensus, poa_msa,
                                                     poa_nwtb, poa_topsort,
                                                     poa_window)
    seen = {}
    orig = {k: getattr(poa_window, k)
            for k in ("topsort", "consensus", "graph_nw_traceback",
                      "msa_rows")}

    def spy(k):
        def run(*args):
            seen[k] = args
            return orig[k](*args)
        return run

    bs = BatchSize(**cfg)
    S, L = bs.max_sequences_per_poa, bs.padded_seq
    _, _, arrays = poa_window_arrays(n, blen, S, edits, L,
                                        SEED + 20 + S)
    for k in orig:
        setattr(poa_window, k, spy(k))
    try:
        poa_window.run_windows(bs, PoaScores(), banded,
                               *(torch.as_tensor(a).cuda() for a in arrays),
                               msa)
    finally:
        for k, f in orig.items():
            setattr(poa_window, k, f)
    level, npred, pred, nc, nc_pre = (x.contiguous()
                                      for x in seen["topsort"])
    W, N, P = pred.shape
    topo_plan = poa_topsort.topsort_plan(N)
    assert topo_plan[0] == "warp-shared"

    def topo(lib, ts):  # one launcher in both builds
        turns_checked("topsort", lib.cga_poa_topsort(
            *turns_ptrs(level, npred, pred, nc, nc_pre, *ts), None, W, N, P,
            topo_plan[1], turns_stream()))
        return ts

    ts, ts2 = ([torch.empty_like(level) for _ in range(3)]
               + [torch.empty(W, dtype=torch.int32, device="cuda")]
               for _ in range(2))

    *cin, MC = seen["consensus"]
    cin = [x.contiguous() for x in cin]
    cons_plan = poa_consensus.consensus_plan(W, N, P, MC)
    assert cons_plan[0] == "warp-shared"
    co, co2 = ([torch.empty((W, MC), dtype=torch.int32, device="cuda")
                for _ in range(2)]
               + [torch.empty(W, dtype=torch.int32, device="cuda")]
               for _ in range(2))

    def cons_cur():
        err = cur.cga_poa_consensus(*turns_ptrs(*cin, *co), None, W, N, P, MC,
                                    cons_plan[1], turns_stream())
        turns_checked("consensus", err)
        return co

    def cons_par():     # the parent's: a block a window
        err = par.cga_poa_consensus(*turns_ptrs(*cin, *co2), None, W, N, P,
                                    MC, turns_stream())
        turns_checked("consensus", err)
        return co2

    shape = f"W={W} N={N} P={P}"
    out = [(f"B7 poa_topsort {tag} {shape} (this: {topo_plan})",
            lambda: topo(cur, ts), lambda: topo(par, ts2), None),
           (f"B8 poa_consensus {tag} {shape} MC={MC} (this: {cons_plan})",
            cons_cur, cons_par, None)]

    if msa:
        state, order = seen["msa_rows"]
        A, (S, Lp) = state.alig.shape[2], state.paths.shape[1:]
        m_in = [x.contiguous() for x in (
            order, state.npred, state.nalig, state.base, state.pred,
            state.alig, state.paths, state.node_count)]
        msa_plan = poa_msa.msa_plan(W, N, P, A, S, Lp)
        assert msa_plan[0] == "warp-shared"
        mo, mo2 = ([torch.empty((W, S, N), dtype=torch.int32, device="cuda"),
                    torch.empty(W, dtype=torch.int32, device="cuda")]
                   for _ in range(2))

        def msa_cur():
            turns_checked("msa", cur.cga_poa_msa(
                *turns_ptrs(*m_in, *mo), None, W, N, P, A, S, Lp, 0,
                msa_plan[1], turns_stream()))
            return mo

        def msa_par():  # the parent's: a block a window
            turns_checked("msa", par.cga_poa_msa(
                *turns_ptrs(*m_in, *mo2), W, N, P, A, S, Lp, turns_stream()))
            return mo2

        out.append((f"B9 poa_msa {tag} {shape} A={A} S={S} L={Lp} (this: "
                    f"{msa_plan})", msa_cur, msa_par, None))

    # B5, in its plan (its body now in poa_nwtb.cuh)
    *nin, sc, bw = seen["graph_nw_traceback"]
    nin = [x.contiguous() for x in nin[:9]] + [nin[9].to(torch.int32)]
    Ln = nin[0].shape[1]
    word = poa_nwtb.nwtb_word_bytes(N, Ln, sc)
    variant, threads, ring = poa_nwtb.nwtb_plan(W, N, P, Ln, bw, word)

    def nw_bufs():
        return [torch.empty((W, N + 1, Ln + 1), dtype=torch.int32,
                            device="cuda")] + [
            torch.empty((W, N + Ln), dtype=torch.int32, device="cuda")
            for _ in range(2)] + [torch.empty(W, dtype=torch.int32,
                                              device="cuda")
                                  for _ in range(2)]

    nb, nb2 = nw_bufs(), nw_bufs()

    def nw_call(lib, bufs):
        err = lib.cga_poa_nwtb(
            *turns_ptrs(*nin, *bufs), W, N, P, Ln, sc.match_score,
            sc.mismatch_score, sc.gap_score, bw, int(variant == "block"),
            threads, ring, poa_nwtb.ring_width(Ln, bw), word, turns_stream())
        turns_checked("poa_nwtb", err)
        return bufs[1:]     # the plane outside the band is never written

    out.insert(1, (f"B5 poa_nwtb {tag} {shape} L={Ln} ({variant})",
                   lambda: nw_call(cur, nb), lambda: nw_call(par, nb2), None))
    out.append(turns_add_pair(cur, par, tag, last_add_args(
        cfg, n, blen, edits, banded, msa)))

    # B10 at the window route's first launch (one launcher in both builds;
    # the parent's slice of device scratch is its own, larger)
    Ww = len(poa.launch_chunks(n, bs, msa, kernel="window")[0])
    wa = [torch.as_tensor(a[:Ww]).contiguous().cuda() for a in arrays]
    bw = bs.band_width if banded else 0

    def win():
        return poa_window.poa_window(*wa, bs, PoaScores(), banded, msa)

    def win_parent_scratch():
        mine = poa_window.window_scratch_bytes
        poa_window.window_scratch_bytes = turns_parent_window_scratch
        try:
            return win()
        finally:
            poa_window.window_scratch_bytes = mine

    plan = poa_window.window_plan(Ww, bs, bw)
    out.append((f"B10 poa_window {tag} W={Ww} N={N} L={L} P={P}"
                f"{' msa' * msa} (this: {plan})", win,
                turns_via(par, win_parent_scratch), None))
    return out


def turns_prepped_ms(fn, prep, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card by CUDA events around each
    launch alone, ``prep()`` run untimed before each."""
    import torch
    total = 0.0
    for _ in range(reps):
        prep()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_turns_main(parent: str) -> int:
    """``--turns PARENT_DIR``: each kernel of this checkout and of
    PARENT_DIR's build on the same inputs, outputs checked equal, then
    timed in turns."""
    import statistics
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from claragenomicsanalysis_tpu_torch.ops import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cur, par = _build.load(), turns_parent_lib(parent)
    pairs = turns_banded_pairs(cur, par)
    pairs += turns_poa_pairs(cur, par, "correction", POA_CORR, N_POA, 128,
                             6, False)
    pairs += turns_poa_pairs(cur, par, "deep", POA_DEEP, N_POA_DEEP, 256,
                             12, True)
    pairs += turns_poa_pairs(cur, par, "msa", POA_MSA, N_POA, 100, 5,
                             False, msa=True)
    for name, fc, fp, prep in pairs:
        if prep:
            prep()
        a, b = fc(), fp()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b, strict=True)):
            raise RuntimeError(f"{name}: the two builds disagree")
        fc(), fp()  # warm
        ms = {"parent": [], "this": []}
        for _ in range(TURNS_ROUNDS):
            for who, f in (("parent", fp), ("this", fc), ("this", fc),
                           ("parent", fp)):
                ms[who].append(cuda_ms(f, TURNS_REPS)[0] if prep is None
                               else turns_prepped_ms(f, prep, TURNS_REPS))
        mp, mc = (statistics.median(ms[k]) for k in ("parent", "this"))
        print(f"{name}: parent {mp:.4f} ms, this {mc:.4f} ms "
              f"({(mc / mp - 1) * 100:+.1f} %), outputs equal; samples "
              f"parent {[round(x, 4) for x in ms['parent']]}, this "
              f"{[round(x, 4) for x in ms['this']]}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--nwtb-split"]:
        sys.exit(nwtb_split_main())
    if sys.argv[1:] == ["--window-split"]:
        sys.exit(window_split_main())
    if sys.argv[1:] == ["--add-split"]:
        sys.exit(add_split_main())
    if sys.argv[1:] == ["--topsort-split"]:
        sys.exit(topsort_split_main())
    if sys.argv[1:] == ["--finish-split"]:
        sys.exit(finish_split_main())
    if sys.argv[1:2] == ["--map-profile"] and len(sys.argv) <= 3:
        sys.exit(map_profile_main(sys.argv[2] if len(sys.argv) == 3 else
                                  os.path.join(ROOT, "build",
                                               "map_profile.txt")))
    if len(sys.argv) == 3 and sys.argv[1] == "--turns":
        sys.exit(kernel_turns_main(sys.argv[2]))
    if sys.argv[1:] == ["--multi-rank"]:
        sys.exit(multi_rank_main())
    if sys.argv[1:] == ["--compositions"]:
        sys.exit(compositions_main())
    if len(sys.argv) > 1:
        sys.exit("usage: python3 chip_smoke.py [--nwtb-split | "
                 "--window-split | --add-split | --topsort-split | "
                 "--finish-split | --map-profile [OUT] | --turns "
                 "PARENT_DIR | --compositions | --multi-rank]")
    sys.exit(main())
