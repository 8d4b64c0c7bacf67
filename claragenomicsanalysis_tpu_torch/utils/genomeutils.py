"""Sequence encoding and reverse complement (copies from
``claragenomicsanalysis_tpu/utils/genomeutils.py``) and the packing of pairs
into the kernels' arrays.

Encoding: A=0, C=1, G=2, T=3 as int8.  Ambiguous bases (N, IUPAC codes,
anything not ACGTacgt) encode to -1, the padding value too: every match
predicate is ``(a == b) & (a >= 0)``, so an unknown base never matches
anything, not even another unknown.  Validity therefore always comes from
explicit lengths, never from scanning for -1.
"""

import numpy as np

BASES = "ACGT"
PAD = -1

_ENC = np.full(256, PAD, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _ENC[ord(_b)] = _i
    _ENC[ord(_b.lower())] = _i

_DEC = np.frombuffer(BASES.encode(), dtype=np.uint8)


def encode(seq: str, length: int | None = None) -> np.ndarray:
    """Encode an ACGT string to int8 codes, optionally padded to `length`."""
    a = _ENC[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if length is None:
        return a
    if len(a) > length:
        raise ValueError(f"sequence length {len(a)} > padded length {length}")
    out = np.full(length, PAD, dtype=np.int8)
    out[: len(a)] = a
    return out


def decode(codes: np.ndarray, length: int | None = None) -> str:
    """Decode int8 codes to a string; negative codes decode to 'N'.  With no
    explicit length, the trailing negative run is treated as padding and
    trimmed (internal negatives are ambiguous input bases, kept as 'N')."""
    codes = np.asarray(codes)
    if length is not None:
        codes = codes[:length]
    else:
        nz = np.nonzero(codes >= 0)[0]
        codes = codes[: int(nz[-1]) + 1] if nz.size else codes[:0]
    out = _DEC[np.clip(codes, 0, 3).astype(np.intp)]
    out = np.where(codes >= 0, out, np.uint8(ord("N")))
    return out.tobytes().decode()


def reverse_complement(seq: str) -> str:
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return seq.translate(comp)[::-1]


def pack_pairs(queries: list[str], targets: list[str], Lq: int, Lt: int):
    """Sequences -> (q (B, Lq), qlen (B,), t (B, Lt), tlen (B,)) NumPy
    arrays: int8 base codes with -1 PAD, int32 lengths."""
    B = len(queries)
    q = np.full((B, Lq), PAD, dtype=np.int8)
    t = np.full((B, Lt), PAD, dtype=np.int8)
    for b, (qs, ts) in enumerate(zip(queries, targets)):
        q[b] = encode(qs, Lq)
        t[b] = encode(ts, Lt)
    qlen = np.array([len(s) for s in queries], dtype=np.int32)
    tlen = np.array([len(s) for s in targets], dtype=np.int32)
    return q, qlen, t, tlen
