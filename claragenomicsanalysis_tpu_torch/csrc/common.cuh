// Constants shared by the kernels of this library.  They are the values the
// JAX package uses (ops/nw_band.py INF, ops/poa_ops.py NEG, core/status.py
// AlignmentState), so the arrays the two packages produce can be fed across.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cga {

// Score of a cell outside the band.  INF + 1 still fits in int32, so the
// 3-way min never overflows.
constexpr int kInf = 1 << 30;

// Score of a POA cell or node no path reaches (poa_ops.NEG), a different
// convention from kInf: POA maximises.  Sums on it stay plain int32.
constexpr int kNeg = -(1 << 30);

// 2-bit move codes (AlignmentState): 0 MATCH, 1 MISMATCH, 2 INSERTION
// (consumes a query base), 3 DELETION (consumes a target base).
constexpr int kInsertion = 2;
constexpr int kDeletion = 3;

// every lane of a warp, for the *_sync intrinsics
constexpr unsigned kFull = 0xffffffffu;

}  // namespace cga
