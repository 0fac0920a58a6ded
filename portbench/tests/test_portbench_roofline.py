"""The Godunov kernels' bytes and operations against hand counts at a small
shape, and the roofline reader's arithmetic."""
import torch
import pytest

from portbench import harness, roofline, trace


def test_velpred_call_hand_count():
    n, ng = (4, 5, 6), 3
    P = tuple(s + 2 * ng for s in n)
    u = torch.zeros((3,) + P, dtype=torch.float64)
    f = torch.zeros_like(u)
    outs = [torch.zeros(tuple(n[t] + (t == d) for t in range(3)),
                        dtype=torch.float64) for d in range(3)]
    b, ops = roofline.velpred_call(
        {"u": u, "force": f, "n_cell": n, "slope_order": 4}, tuple(outs))
    # inputs 2 x 3 x 10*11*12 doubles; outputs 5*5*6 + 4*6*6 + 4*5*7
    assert b == 8 * (2 * 3 * 10 * 11 * 12 + 150 + 144 + 140)
    # velpred per cell: 6 + 9*28 + 3*(8+12+9+14) + 6*(4+2+7) + 3*(9+2+3+9)
    assert roofline.velpred_ops(4) == 6 + 252 + 129 + 78 + 69 == 534
    assert ops == 534 * 120


def test_mkflux_update_call_hand_count():
    n, ng = (4, 4, 4), 3
    P = (10, 10, 10)
    s = torch.zeros((2,) + P, dtype=torch.float32)
    macs = [torch.zeros(P, dtype=torch.float32) for _ in range(3)]
    snew = torch.zeros((2,) + n, dtype=torch.float32)
    a = {"s": s, "mac_pads": macs, "force": None, "mac_rhs": None,
         "fupd": None, "is_conservative": [True, False], "n_cell": n,
         "slope_order": 4}
    b, ops = roofline.mkflux_update_call(a, snew)
    assert b == 4 * (2 * 1000 + 3 * 1000 + 2 * 64)
    # conservative: 84 + 51 + 6*(3+2+7) + 3*(15+2+7) + 11 + 2 = 292
    # convective:   84 + 51 + 6*(4+2+7) + 3*(9+2+7) + 17 + 2 = 286
    assert roofline.mkflux_update_ops([True, False], False, False, 4) == \
        6 + 292 + 286
    assert ops == 584 * 64


def test_bound_is_the_larger_time():
    assert roofline.bound_s(3.35e12, 0, "float64") == pytest.approx(1.0)
    assert roofline.bound_s(0, 34e12, "float64") == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 68e12, "float64") == pytest.approx(2.0)


def test_roofline_reader_and_trace_reduction():
    # two steps: a velpred brick of 4 us, its tie epsilon 1 us, a smoother
    # 5 us, a copy 2 us; host ranges around them; one idle gap in each
    ev = [("step::macproject", False, 0.0, 20.0),
          ("void vt::absmax_boxes<double>(vt::Boxes<double>, double*)",
           True, 1.0, 2.0),
          ("void vt::velpred_brick_kernel<double>(vt::VP)", True, 2.0, 6.0),
          ("step::macproject", True, 2.0, 6.0),
          ("void vt::nodal_fused_kernel<double>(vt::NF)", True, 10.0, 15.0),
          ("Memcpy DtoH (Device -> Pageable)", True, 30.0, 32.0)]
    s = trace.summarize(ev, {"step::macproject"}, 2, 40e-6)
    assert s["ops"] == 4
    assert s["busy_s"] == pytest.approx(12e-6)
    assert s["idle_by_range"] == pytest.approx(
        {"step::macproject": 4e-6, "outside step::": 15e-6})
    assert s["kernels"]["velpred_brick_kernel"] == pytest.approx((4e-6, 1))
    view = harness.RunView([{"seconds": 1.0, "cells": 8, "outer": None}] * 2,
                           6, s, 2.5e-6)
    read = harness.load_reader
    assert read("godunov_roofline")(view) == pytest.approx(50.0)
    assert read("smoother_ms_per_step")(view) == pytest.approx(2.5e-3)
    assert read("device_idle_share")(view) == pytest.approx(70.0)
    assert read("device_ops_per_step")(view) == 2.0
    assert read("part_ms.macproject")(view) == pytest.approx(1e-2)
    assert read("vcycles_per_step")(view) == 3.0
    assert read("outer_cycles_per_step")(view) is None
    assert read("part_ms.hgproject")(view) is None
