"""The card's published peaks and the kernels' counted work: the yardstick
of every ``*_roofline`` metric.

NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 132 SMs of 64
int32 lanes at the 1,980 MHz boost clock, 16.727 T int32 operations/s, and
3.35 TB/s of HBM3.  A roofline share is the least time these allow for the
work the inputs need, over the kernel's measured time.

B4 (``myers``, ``csrc/myers.cu``; the JAX package's
``ops/myers_pallas.py``): 27 int32 operations a query word (32 bases) that
a problem needs and a column of its launch's target row; the query, the
target and the lengths read once, the bottom rows and scores written once.
"""

SMS = 132
INT32_LANES = 64
BOOST_MHZ = 1980
INT32_OPS_PER_S = SMS * INT32_LANES * BOOST_MHZ * 1e6    # 16.727e12
HBM_BYTES_PER_S = 3.35e12

OPS_PER_MYERS_WORD = 27


def myers_work(B: int, Lq: int, Lt: int, words: int) -> tuple[float, float]:
    """(int32 operations, bytes) of one B4 launch: B problems, queries
    padded to Lq and targets to Lt bases, ``words`` the query words the
    problems need in all (sum of ceil(qlen / 32))."""
    ops = OPS_PER_MYERS_WORD * words * Lt
    nbytes = B * Lq + B * Lt + 8 * B + 4 * B * (Lt + 1) + 4 * B
    return float(ops), float(nbytes)


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of operations at
    the int32 peak and bytes at the memory peak."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
