"""The trace's arithmetic on a made-up stretch: busy time is the union of
kernel intervals, idle gaps are named by the host operation under them,
and a profile with fewer DCN kernels than launched is incomplete."""

from __future__ import annotations

import pytest

from portbench import trace


def _stretch(kernels, launched=None, host=()):
    return trace.Stretch(0.0, 10.0, kernels, [], list(host),
                         launched or {}, {
                             k: sum(k in n for n, _, _ in kernels)
                             for k in trace.KERNELS_PER_LAUNCH})


def test_busy_is_the_union_of_intervals():
    st = _stretch([("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0),
                   ("d", 9.5, 12.0)])
    assert st.busy_s() == pytest.approx(3.0 + 1.0 + 0.5)
    assert st.window_s == 10.0


def test_lost_dcn_records_make_the_profile_incomplete():
    kernels = [("dcn_fwd_wgmma_kernel", 0.0, 1.0)] * 15
    assert not _stretch(kernels, {"dcn_fwd": 16}).complete
    assert _stretch(kernels + kernels[:1], {"dcn_fwd": 16}).complete
    bwd = [("dcn_bwd_dx_kernel", 0.0, 1.0), ("dcn_bwd_dw_kernel", 1, 2)]
    assert not _stretch(bwd, {"dcn_bwd": 2}).complete
    assert _stretch(bwd * 2, {"dcn_bwd": 2}).complete


def test_breakdown_names_gaps_and_ops():
    st = _stretch([("void k1<int>(float*)", 0.0, 4.0), ("k2", 6.0, 10.0)],
                  host=[("cudaMemcpyAsync", 4.5, 5.5),
                        ("aten::copy_", 3.0, 6.0)])
    out = trace.breakdown(st)
    assert out["device_ops"][0][0] == "k1"
    assert out["idle_gaps"] == [["cudaMemcpyAsync", 2.0]]
