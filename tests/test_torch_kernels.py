"""ops/kernels.py on the CPU: the ptxas report parser on canned
``nvcc -Xptxas -v`` logs, and the build flags that produce those logs. The
kernels themselves build and run only on the card (``chip_smoke.py``)."""

import pytest

from codemix_dense_retrieval_torch.ops import kernels

_BM = "_ZN46_GLOBAL__N__0d72f34e_13_bin_scores_cu_147f33a920bin_scores_bm_kernelILi256ELi8EfLb1ELb0EEEvv"
_K5 = "_ZN46_GLOBAL__N__0d72f34e_13_bin_scores_cu_147f33a918binmax_only_kernelILi8EEEvPK13__nv_bfloat16"

LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{_BM}' for 'sm_90a'
ptxas info    : Function properties for {_BM}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '{_K5}' for 'sm_90a'
ptxas info    : Function properties for {_K5}
    24 bytes stack frame, 20 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 126 registers, 408 bytes cmem[0]
ptxas info    : Function properties for _ZN4sm904helperEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = kernels.ptxas_report(LOG)
    assert rep["kernels"] == {
        _BM: {"registers": 168, "spill_bytes": 0},
        _K5: {"registers": 126, "spill_bytes": 32},
    }
    assert rep["warnings"] == [] and rep["serialized"] == []


@pytest.mark.parametrize("level", ["warning", "info   "])
def test_ptxas_report_flags_serialised_wgmma(level):
    note = (f"ptxas {level} : (C7518) Potential Performance Loss: wgmma.mma_async instructions "
            f"are serialized due to WG.DP in divergent path in the function '{_BM}'")
    rep = kernels.ptxas_report(LOG + note + "\n")
    assert rep["serialized"] == [_BM]
    assert rep["warnings"] == [note]
    assert rep["kernels"][_BM] == {"registers": 168, "spill_bytes": 0}


def test_ptxas_report_keeps_other_warnings_apart_from_serialisation():
    note = "bin_scores.cu(12): warning #177-D: variable \"x\" was declared but never referenced"
    rep = kernels.ptxas_report(note + "\n" + LOG)
    assert rep["warnings"] == [note] and rep["serialized"] == []


def test_build_asks_ptxas_for_its_report_and_hashes_the_flags(monkeypatch):
    flags = kernels.NVCC_FLAGS
    assert flags[flags.index("-Xptxas") + 1] == "-v"
    path = kernels._library_path("bin_scores")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", [f for f in flags if f not in ("-Xptxas", "-v")])
    assert kernels._library_path("bin_scores") != path
    assert path.name.startswith("libbin_scores.") and path.suffix == ".so"
