"""The port's kernel build helpers on the CPU (no nvcc here): the build's
name covers every header beside a source, and the ptxas and SASS reports
are read as chip_smoke.py prints them."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6ssd_cbIfEvPKT_S2_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z6ssd_cbIfEvPKT_S2_Pfiiiiii
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers, 1024 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14ssd_state_passPfPKfS_iii' for 'sm_90a'
ptxas info    : Function properties for _Z14ssd_state_passPfPKfS_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 392 bytes cmem[0]
"""

SASS = """\
        Function : _Z17flash_gqa_fwd_mmaILi64EEvPK13__nv_bfloat16S2_S2_PKiPS0_iiiiiif
        /*0100*/   LDSM.16.M88.4 R4, [R2] ;
        /*0110*/   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0120*/   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;
        Function : _Z14ssd_state_passPfPKfS_iii
        /*0010*/   FFMA R1, R2, R3, R4 ;
        Function : _Z3fooi
        /*0030*/   HGMMA.64x128x16.F32.BF16 gdesc[UR4], RZ, !UPT ;
"""


def _kernel_dir(tmp_path):
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "tc.cuh"\n')
    (csrc / "tc.cuh").write_text("// v1\n")
    return csrc


def test_target_covers_headers(tmp_path):
    csrc = _kernel_dir(tmp_path)
    src = csrc / "k.cu"
    first = _build.target(src)
    assert _build.headers(src) == [csrc / "tc.cuh"]
    (csrc / "tc.cuh").write_text("// v2\n")
    second = _build.target(src)
    assert second != first and second.suffix == ".so"
    (csrc / "extra.h").write_text("// new header\n")
    assert _build.target(src) != second
    src.write_text('#include "tc.cuh"\n// edited\n')
    assert _build.target(src) not in (first, second)


def test_target_is_stable(tmp_path):
    src = _kernel_dir(tmp_path) / "k.cu"
    assert _build.target(src) == _build.target(src)


def test_parse_ptxas():
    res = _build.parse_ptxas(PTXAS_LOG)
    assert res == {
        "_Z6ssd_cbIfEvPKT_S2_Pfiiiiii": {
            "registers": 62, "smem_bytes": 1024, "spill_stores": 8,
            "spill_loads": 4},
        "_Z14ssd_state_passPfPKfS_iii": {
            "registers": 32, "smem_bytes": 0, "spill_stores": 0,
            "spill_loads": 0}}


def test_count_tensor_core_ops():
    assert _build.count_tensor_core_ops(SASS) == {
        "_Z17flash_gqa_fwd_mmaILi64EEvPK13__nv_bfloat16S2_S2_PKiPS0_iiiiiif":
            2,
        "_Z14ssd_state_passPfPKfS_iii": 0, "_Z3fooi": 1}


@pytest.mark.parametrize("kind,counts", [("HGMMA", (0, 0, 1)),
                                         ("HMMA", (2, 0, 0))])
def test_count_tensor_core_ops_of_one_kind(kind, counts):
    """wgmma's HGMMA apart from mma.sync's HMMA, as the card test of the
    wgmma body asks."""
    got = _build.count_tensor_core_ops(SASS, kinds=(kind,))
    assert tuple(got.values()) == counts
