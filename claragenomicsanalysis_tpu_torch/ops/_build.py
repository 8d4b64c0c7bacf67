"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/torch_kernels/<hash>/`` at the root of
the checkout, or under the user's cache directory for an installed package
(:func:`build_root`).  The hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads the library already built.  Including no
PyTorch header keeps one build at seconds rather than minutes.

A failed build raises :class:`KernelBuildError`; a launcher that returns a
CUDA error raises :class:`KernelLaunchError` (see :func:`check`).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
LIB_NAME = "libcga_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

#: dynamic shared memory one block can have on Hopper (227 KB); a kernel's
#: shared-memory variant runs only where its bytes fit, its device-memory
#: variant elsewhere
SMEM_PER_BLOCK = 232_448

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
#: argtypes of every launcher: a pointer or the stream is c_void_p, an int
#: c_int (ctypes would otherwise pass a pointer as a 32-bit int)
SIGNATURES = {
    "cga_nw_diag": (_PTR,) * 7 + (_INT,) * 9 + (_PTR,),
    "cga_tb_decode_diag": (_PTR,) * 5 + (_INT,) * 8 + (_PTR,),
    "cga_nw_row": (_PTR,) * 7 + (_INT,) * 10 + (_PTR,),
    "cga_tb_decode_row": (_PTR,) * 5 + (_INT,) * 8 + (_PTR,),
    "cga_myers": (_PTR,) * 7 + (_INT,) * 5 + (_PTR,),
    "cga_poa_topsort": (_PTR,) * 10 + (_INT,) * 4 + (_PTR,),
    "cga_poa_nwtb": (_PTR,) * 15 + (_INT,) * 13 + (_PTR,),
    "cga_poa_add": (_PTR,) * 17 + (_INT,) * 8 + (_PTR,),
    "cga_poa_consensus": (_PTR,) * 11 + (_INT,) * 5 + (_PTR,),
    "cga_poa_msa": (_PTR,) * 11 + (_INT,) * 8 + (_PTR,),
    "cga_poa_window": (_PTR,) * 13 + (_INT,) * 18 + (_PTR,),
    "cga_cigar": (_PTR,) * 7 + (_INT,) * 3 + (_PTR,),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """A launcher returned a CUDA error."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_root(package_dir: Path = PACKAGE_DIR) -> Path:
    """``build/torch_kernels`` of the checkout when the package runs from
    one (a ``pyproject.toml`` beside the package directory); otherwise, as
    for an installed package, ``claragenomicsanalysis_tpu_torch/kernels``
    under ``$XDG_CACHE_HOME`` or ``~/.cache``."""
    checkout = Path(package_dir).parent
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "claragenomicsanalysis_tpu_torch" / "kernels"


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return build_root() / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless a library for them exists; return it.
    Each ``.cu`` file compiles in its own ``nvcc`` process, all started
    together, and one more links the objects."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    # nvcc tells an object from a source by its suffix: keep ".o" last
    objs = [lib.with_name(f"{p.stem}.{tag}.o") for p in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for p, o in zip(cus, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{LIB_NAME}.{tag}")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    (lib.parent / "build.log").write_text("".join(logs) + link.stdout)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(p.name, proc.returncode, log) for p, proc, log
              in zip(cus, procs, logs) if proc.returncode != 0]
    if link.returncode != 0 and not failed:
        failed = [("link", link.returncode, link.stdout)]
    if failed:
        raise KernelBuildError("\n".join(
            f"nvcc {name} exited {rc}:\n{log[-4000:]}"
            for name, rc, log in failed))
    os.replace(tmp, lib)        # atomic: a reader never sees half a library
    return lib


def build_log() -> str:
    """nvcc's output (ptxas registers and shared memory) of the last build."""
    log = library_path().parent / "build.log"
    return log.read_text() if log.is_file() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cga_error_string.argtypes = [ctypes.c_int]
    lib.cga_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.cga_error_string(err).decode()
        raise KernelLaunchError(f"{kernel}: CUDA error {err}: {msg}")
