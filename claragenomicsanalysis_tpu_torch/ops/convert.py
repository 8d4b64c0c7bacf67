"""Carry arrays across the two packages: the aligner's packed problems and
traceback, and the POA graph state.

The JAX package's arrays (``claragenomicsanalysis_tpu``) are ``q``/``t``
(B, L) int8 codes with -1 PAD, ``qlen``/``tlen`` (B,) int32 and a packed
traceback ``tb`` (rows, B, W) int8: the anti-diagonal one, (Dpad / 4, B,
round_up(r + 1, 8)), or the row one, (round_up(Lq, 16) / 4, B,
round_up(2r + 1, 8)).  Both have the batch on axis 1, so one check carries
either.  The port keeps the same layouts as torch tensors, so conversion is
a copy and a dtype check, never a reshuffle.
"""

import numpy as np
import torch

from ..utils.profiling import to_host

_DTYPES = {"q": np.int8, "qlen": np.int32, "t": np.int8, "tlen": np.int32,
           "tb": np.int8}
_NDIM = {"q": 2, "qlen": 1, "t": 2, "tlen": 1, "tb": 3}


def _checked(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != _DTYPES[name] or a.ndim != _NDIM[name]:
        raise ValueError(f"{name}: want {_NDIM[name]}-d "
                         f"{np.dtype(_DTYPES[name])}, got {a.ndim}-d "
                         f"{a.dtype}")
    return a


def _check_batch(arrays: dict) -> None:
    B = arrays["q"].shape[0]
    sizes = {n: (a.shape[1] if n == "tb" else a.shape[0])
             for n, a in arrays.items() if a is not None}
    if any(s != B for s in sizes.values()):
        raise ValueError(f"batch sizes disagree: {sizes}")


def from_reference(q, qlen, t, tlen, tb=None, device="cpu") -> tuple:
    """The JAX package's arrays (NumPy or anything ``np.asarray`` takes) ->
    the port's tensors on ``device``: (q, qlen, t, tlen, tb), tb None when
    not given."""
    arrays = {"q": q, "qlen": qlen, "t": t, "tlen": tlen, "tb": tb}
    arrays = {n: None if a is None else _checked(n, a)
              for n, a in arrays.items()}
    _check_batch(arrays)
    # np.array copies: arrays from JAX are read-only, tensors are not
    return tuple(None if a is None else torch.from_numpy(np.array(a)).to(device)
                 for a in arrays.values())


def to_reference(q, qlen, t, tlen, tb=None) -> tuple:
    """The port's tensors -> NumPy arrays in the JAX package's layout:
    (q, qlen, t, tlen, tb), tb None when not given."""
    arrays = {"q": q, "qlen": qlen, "t": t, "tlen": tlen, "tb": tb}
    arrays = {n: None if a is None
              else _checked(n, to_host(a.detach()).numpy())
              for n, a in arrays.items()}
    _check_batch(arrays)
    return tuple(arrays.values())


def poa_state_from_reference(state, device="cpu"):
    """The JAX package's POA state, vmapped over windows (``poa_ops.PoaState``
    or any object with its fields, as NumPy-convertible (W, ...) arrays) ->
    the port's ``ops.poa_state.PoaState`` on ``device``, ``paths``
    included (None where the given state has none or holds None)."""
    from .poa_state import PoaState
    out = []
    for name in PoaState._fields:
        a = getattr(state, name, None)
        if a is None and name == "paths":
            out.append(None)
            continue
        a = np.asarray(a)
        if a.dtype != np.int32:
            raise ValueError(f"{name}: want int32, got {a.dtype}")
        out.append(torch.from_numpy(np.array(a)).to(device))
    st = PoaState(*out)
    W = st.node_count.shape[0]
    if any(t.shape[0] != W for t in st.tensors()):
        raise ValueError("window counts of the state's fields disagree")
    return st


def poa_state_to_reference(state) -> dict:
    """The port's ``PoaState`` -> a dict of NumPy arrays named as the JAX
    ``PoaState``'s fields, for ``jax_state._replace(**d)``; ``paths`` is in
    it when the state carries it."""
    return {name: to_host(t.detach()).numpy()
            for name, t in zip(state._fields, state) if t is not None}
