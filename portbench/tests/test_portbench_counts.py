"""request_roofline's counts at set B, level 35, against figures worked by
hand from the definitions in counts/work.py."""

import pytest

from portbench.counts import peaks, work

N = 1 << 16
ROW = 32768 * 16 * 9  # one NTT row: N/2 log2 N butterflies of 9 operations


def test_primitives():
    assert work.ntt(N, 1).int32_ops == ROW == 4_718_592
    assert work.key_bytes(N, 35, 15) == 3 * 2 * 50 * N * 4 == 78_643_200
    assert work.digits(35, 15) == [(0, 15), (15, 30), (30, 35)]
    # conversion of digit 2 (5 rows + count) to the 45 other ext rows
    assert work.conversion(N, 5, 45).tc_ops == 45 * 6 * N * 2


def test_set_b_hmult():
    h = work.hmult(N, 35, 15)
    tensor = 35 * N * (4 * 4 + 1)
    modup = 35 * ROW + 35 * N * 5 + 115 * ROW
    tail = 35 * N + 16 * ROW + 15 * N * 5 + 34 * ROW + 34 * N * 5
    assert h.int32_ops == tensor + modup + 2 * tail == 1_266_810_880
    conv = N * 2 * (35 * 16 + 35 * 16 + 45 * 6)
    ip = 2 * 3 * 50 * N * 2
    assert h.tc_ops == conv + ip + 2 * 34 * 17 * N * 2 == 373_030_912


def test_set_b_hmult_batch_of_8():
    w = work.hmult_batch(N, 35, 15, 8)
    assert w.int32_ops == 8 * 1_266_810_880
    io = 2 * (2 * 35 * N * 4) + 2 * 34 * N * 4
    assert w.bytes == 8 * io + 78_643_200 == 514_850_816
    assert w.bound_by() == "int32"
    assert w.least_s() == pytest.approx(8 * 1_266_810_880 / 16.75e12)
    assert peaks.INT32_OPS_PER_S == 16.75e12


def test_set_b_matvec():
    w = work.matvec_bsgs(N, 35, 15, 64, 8)
    modup = work.modup(N, 35, 15)
    md = work.moddown(N, 35, 15)
    assert md.int32_ops == 15 * ROW + 15 * N * 5 + 35 * ROW + 35 * N * 5
    rot = 2 * md.int32_ops + 35 * N
    prod = 2 * 35 * N * (64 * 4 + 63)
    assert w.int32_ops == 8 * modup.int32_ops + 14 * rot + prod
    assert w.bytes == (2 * 2 * 35 * N * 4 + 64 * 35 * N * 4
                       + 14 * 78_643_200)
