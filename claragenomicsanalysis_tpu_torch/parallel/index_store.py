"""Minimizer-index serialization (copy of
``claragenomicsanalysis_tpu/parallel/index_store.py``): persisted indices
keyed by (content hash, read range, k, w, hashing, filter) serve as both a
compute cache across runs and a resume point.

The ``.npz`` layout is the JAX package's (``arr_rep`` uint32, ``arr_read_id``
/ ``arr_pos`` / ``arr_dir`` int32, ``arr_n_elems``), so an index stored by
either package loads in the other; extra arrays (the JAX package's
``packed`` side array) are ignored on load.
"""

import hashlib
import os

import numpy as np
import torch

from ..core.config import MapperConfig
from ..models.mapper import Index, _sliced, resolve_device

_DTYPES = {"rep": np.uint32, "read_id": np.int32, "pos": np.int32,
           "dir": np.int32}


def index_key(parser, first: int, past_last: int, cfg: MapperConfig) -> str:
    h = hashlib.sha256()
    for i in range(first, past_last):
        r = parser.get_sequence_by_id(i)
        h.update(r.name.encode())
        h.update(b"\x00")
        h.update(r.seq.encode())
        h.update(b"\x01")
    h.update(f"{cfg.kmer_size},{cfg.window_size},{cfg.hash_representations},"
             f"{cfg.filtering_parameter}".encode())
    return h.hexdigest()[:32]


def save_index(index: Index, store_dir: str, key: str) -> str:
    """Write the index under its key; the file appears whole (written
    aside, then renamed), so a rank loading it never reads half a file."""
    os.makedirs(store_dir, exist_ok=True)
    path = os.path.join(store_dir, f"index_{key}.npz")
    tmp = os.path.join(store_dir, f"index_{key}.{os.getpid()}.tmp.npz")
    arrays = {f"arr_{k}": index._arrays[k].cpu().numpy().astype(dt)
              for k, dt in _DTYPES.items()}
    np.savez_compressed(
        tmp,
        first_read_id=index.first_read_id,
        read_lengths=np.array(index.read_lengths, dtype=np.int64),
        read_names=np.array(index.read_names, dtype=object),
        arr_n_elems=np.int32(index.n_elems), **arrays)
    os.replace(tmp, path)
    return path


def load_index(store_dir: str, key: str, device="cuda") -> Index | None:
    device = resolve_device(device)
    path = os.path.join(store_dir, f"index_{key}.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path, allow_pickle=True)
    arrays = {k: torch.from_numpy(z[f"arr_{k}"].astype(
        np.int64 if k == "rep" else np.int32)).to(device) for k in _DTYPES}
    arrays["n_elems"] = int(z["arr_n_elems"])
    return Index(_sliced(arrays), int(z["first_read_id"]),
                 [int(x) for x in z["read_lengths"]],
                 [str(x) for x in z["read_names"]])


def get_or_build(parser, first: int, past_last: int, cfg: MapperConfig,
                 store_dir: str, device="cuda") -> tuple[Index, bool]:
    """Returns (index, was_cached)."""
    key = index_key(parser, first, past_last, cfg)
    idx = load_index(store_dir, key, device=device)
    if idx is not None:
        return idx, True
    idx = Index.create_index(parser, first, past_last, cfg, device=device)
    save_index(idx, store_dir, key)
    return idx, False
