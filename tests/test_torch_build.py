"""The port's kernel build location and kernel timing
(claragenomicsanalysis_tpu_torch.ops._build, .utils.profiling); neither
needs a card."""

import pytest
import torch

from claragenomicsanalysis_tpu_torch.ops import _build, nw_diag
from claragenomicsanalysis_tpu_torch.utils import profiling


def test_build_root_in_checkout_and_installed(tmp_path, monkeypatch):
    repo = _build.PACKAGE_DIR.parent
    assert _build.build_root() == repo / "build" / "torch_kernels"
    assert _build.library_path().parent.parent == _build.build_root()

    site = tmp_path / "site-packages" / "claragenomicsanalysis_tpu_torch"
    site.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_root(site) == (
        tmp_path / "cache" / "claragenomicsanalysis_tpu_torch" / "kernels")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_root(site) == (
        tmp_path / "home" / ".cache" / "claragenomicsanalysis_tpu_torch"
        / "kernels")


def test_kernel_times_records_no_plain_version_call():
    """CPU tensors take the plain version: no launch, so nothing timed."""
    q = torch.zeros((2, 8), dtype=torch.int8)
    n = torch.full((2,), 8, dtype=torch.int32)
    with profiling.kernel_times() as kt:
        nw_diag.banded_nw_diag(q, n, q, n, 4)
        with pytest.raises(RuntimeError, match="nest"):
            with profiling.kernel_times():
                pass
    assert kt.count() == {} and kt.events == {} and kt.largest == {}
    assert profiling._collector is None


@pytest.mark.cuda
def test_kernel_times_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q = torch.zeros((2, 8), dtype=torch.int8, device="cuda")
    n = torch.full((2,), 8, dtype=torch.int32, device="cuda")
    with profiling.kernel_times() as kt:
        nw_diag.banded_nw_diag(q, n, q, n, 4)
        nw_diag.banded_nw_diag(q[:1], n[:1], q[:1], n[:1], 4)
    assert kt.count() == {"nw_diag": 2}
    assert kt.ms()["nw_diag"] > 0
    # the larger launch's inputs, kept for a replay
    assert kt.largest["nw_diag"][0].shape == (2, 8)
    assert kt.largest["nw_diag"][4] == 4
