"""MPS conformance fixtures: fixed-format quirks the
reference consumes through QPSReader (scripts/common.jl:21-36) —
negative RANGES on E/L/G rows, RHS on the objective row, the UP-negative
quirk, short BOUNDS forms — each round-tripped through write_mps and the
LPs cross-checked against scipy's HiGHS."""

import numpy as np
import pytest
from scipy.optimize import linprog

import madqp_tpu as mq
from madqp_tpu.io.mps import read_mps
from madqp_tpu.io.mps_write import write_mps

QUIET = dict(print_level=40)


def _write(tmp_path, text, name="fix.mps"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _highs_obj(qp):
    bounds = [
        (l if np.isfinite(l) else None, u if np.isfinite(u) else None)
        for l, u in zip(qp.lvar, qp.uvar)
    ]
    A = qp.A.toarray()
    eq = qp.lcon == qp.ucon
    ub_rows = np.isfinite(qp.ucon) & ~eq
    lb_rows = np.isfinite(qp.lcon) & ~eq
    A_ub = np.vstack([A[ub_rows], -A[lb_rows]])
    b_ub = np.concatenate([qp.ucon[ub_rows], -qp.lcon[lb_rows]])
    res = linprog(
        qp.c if qp.minimize else -qp.c,
        A_eq=A[eq] if eq.any() else None,
        b_eq=qp.lcon[eq] if eq.any() else None,
        A_ub=A_ub if len(b_ub) else None,
        b_ub=b_ub if len(b_ub) else None,
        bounds=bounds, method="highs",
    )
    assert res.status == 0, res.message
    sign = 1.0 if qp.minimize else -1.0
    return sign * res.fun + qp.c0


# --- fixtures --------------------------------------------------------------

NEG_RANGES = """NAME          NEGRANGES
ROWS
 N  COST
 E  REQ
 L  CAP
 G  FLR
COLUMNS
    X1        COST      1.0        REQ       1.0
    X1        CAP       1.0        FLR       1.0
    X2        COST      2.0        REQ       1.0
    X2        CAP       2.0        FLR       0.5
RHS
    RHS       REQ       4.0        CAP       10.0
    RHS       FLR       1.0
RANGES
    RNG       REQ      -1.5
    RNG       CAP      -3.0
    RNG       FLR      -2.0
BOUNDS
ENDATA
"""


def test_negative_ranges_semantics(tmp_path):
    qp = read_mps(_write(tmp_path, NEG_RANGES))
    # E row, negative range r: [rhs + r, rhs] (QPSReader convention)
    assert qp.lcon[0] == pytest.approx(4.0 - 1.5)
    assert qp.ucon[0] == pytest.approx(4.0)
    # L row: [rhs - |r|, rhs]
    assert qp.lcon[1] == pytest.approx(10.0 - 3.0)
    assert qp.ucon[1] == pytest.approx(10.0)
    # G row: [rhs, rhs + |r|]
    assert qp.lcon[2] == pytest.approx(1.0)
    assert qp.ucon[2] == pytest.approx(1.0 + 2.0)


def test_negative_ranges_solve_matches_highs(tmp_path):
    qp = read_mps(_write(tmp_path, NEG_RANGES))
    stats = mq.solve(qp, **QUIET)
    assert stats.status == mq.Status.SOLVE_SUCCEEDED
    assert stats.objective == pytest.approx(_highs_obj(qp), abs=1e-7)


RHS_ON_OBJ = """NAME          RHSOBJ
ROWS
 N  COST
 G  R1
COLUMNS
    X1        COST      3.0        R1        1.0
RHS
    RHS       R1        2.0        COST      5.0
ENDATA
"""


def test_rhs_on_objective_row(tmp_path):
    # RHS entry on the objective row is a NEGATED objective constant.
    qp = read_mps(_write(tmp_path, RHS_ON_OBJ))
    assert qp.c0 == pytest.approx(-5.0)
    stats = mq.solve(qp, **QUIET)
    assert stats.objective == pytest.approx(3.0 * 2.0 - 5.0, abs=1e-7)


UP_NEGATIVE = """NAME          UPNEG
ROWS
 N  COST
 G  R1
COLUMNS
    X1        COST      1.0        R1        1.0
    X2        COST      1.0        R1        1.0
    X3        COST      1.0        R1        1.0
RHS
    RHS       R1        -6.0
BOUNDS
 UP BND       X1        -2.0
 UP BND       X2        -1.0
 LO BND       X2        -5.0
 UP BND       X3        4.0
ENDATA
"""


def test_up_negative_quirk(tmp_path):
    qp = read_mps(_write(tmp_path, UP_NEGATIVE))
    # X1: UP<0 with no LO => lower bound becomes -inf (classic MPS quirk)
    assert qp.uvar[0] == pytest.approx(-2.0)
    assert qp.lvar[0] == -np.inf
    # X2: explicit LO present => stays
    assert qp.lvar[1] == pytest.approx(-5.0)
    assert qp.uvar[1] == pytest.approx(-1.0)
    # X3: plain UP>0 keeps default lower bound 0
    assert qp.lvar[2] == 0.0
    assert qp.uvar[2] == pytest.approx(4.0)
    stats = mq.solve(qp, **QUIET)
    assert stats.status == mq.Status.SOLVE_SUCCEEDED
    assert stats.objective == pytest.approx(_highs_obj(qp), abs=1e-7)


SHORT_BOUNDS = """NAME          SHORTB
ROWS
 N  COST
 E  R1
COLUMNS
    X1        COST      1.0        R1        1.0
    X2        COST      -1.0       R1        1.0
    X3        COST      2.0        R1        1.0
    X4        COST      0.5        R1        1.0
RHS
    RHS       R1        3.0
BOUNDS
 FR BND       X1
 MI BND       X2
 UP BND       X2        2.0
 PL BND       X3
 FX BND       X4        0.25
ENDATA
"""


def test_short_bounds_forms(tmp_path):
    qp = read_mps(_write(tmp_path, SHORT_BOUNDS))
    assert qp.lvar[0] == -np.inf and qp.uvar[0] == np.inf      # FR
    assert qp.lvar[1] == -np.inf and qp.uvar[1] == 2.0         # MI + UP
    assert qp.lvar[2] == 0.0 and qp.uvar[2] == np.inf          # PL
    assert qp.lvar[3] == 0.25 and qp.uvar[3] == 0.25           # FX
    stats = mq.solve(qp, **QUIET)
    assert stats.status == mq.Status.SOLVE_SUCCEEDED
    assert stats.objective == pytest.approx(_highs_obj(qp), abs=1e-6)


OBJSENSE_MAX = """NAME          MAXLP
OBJSENSE
    MAX
ROWS
 N  PROFIT
 L  CAP
COLUMNS
    X1        PROFIT    3.0        CAP       1.0
    X2        PROFIT    5.0        CAP       2.0
RHS
    RHS       CAP       10.0
BOUNDS
 UP BND       X1        6.0
 UP BND       X2        4.0
ENDATA
"""


def test_objsense_max(tmp_path):
    qp = read_mps(_write(tmp_path, OBJSENSE_MAX))
    assert not qp.minimize
    stats = mq.solve(qp, **QUIET)
    assert stats.status == mq.Status.SOLVE_SUCCEEDED
    # max 3x1+5x2 st x1+2x2<=10, x1<=6, x2<=4: x2=4 -> x1=2? x1+8<=10 ->
    # x1=2: obj 6+20=26; or x1=6 -> 2x2<=4, x2=2: 18+10=28.
    assert stats.objective == pytest.approx(28.0, abs=1e-6)


QUADOBJ_QP = """NAME          TINYQP
ROWS
 N  COST
 G  R1
COLUMNS
    X1        COST      -1.0       R1        1.0
    X2        COST      -2.0       R1        1.0
RHS
    RHS       R1        0.5
QUADOBJ
    X1        X1        2.0
    X1        X2        0.5
    X2        X2        2.0
ENDATA
"""


def test_quadobj_lower_triangle(tmp_path):
    qp = read_mps(_write(tmp_path, QUADOBJ_QP))
    H = qp.H.toarray()
    np.testing.assert_allclose(H, [[2.0, 0.5], [0.5, 2.0]])
    stats = mq.solve(qp, **QUIET)
    assert stats.status == mq.Status.SOLVE_SUCCEEDED
    # unconstrained minimum: H x = -c -> x = H^-1 [1, 2]; check feasibility
    x_uc = np.linalg.solve(H, [1.0, 2.0])
    if x_uc.sum() >= 0.5 and (x_uc >= 0).all():
        np.testing.assert_allclose(stats.solution, x_uc, atol=1e-6)


ALL_FIXTURES = [NEG_RANGES, RHS_ON_OBJ, UP_NEGATIVE, SHORT_BOUNDS,
                OBJSENSE_MAX, QUADOBJ_QP]


@pytest.mark.parametrize("text", ALL_FIXTURES)
def test_write_mps_round_trip(tmp_path, text):
    qp1 = read_mps(_write(tmp_path, text, "orig.mps"))
    out = str(tmp_path / "rt.mps")
    write_mps(qp1, out)
    qp2 = read_mps(out)
    assert qp2.nvar == qp1.nvar and qp2.ncon == qp1.ncon
    np.testing.assert_allclose(qp2.c, qp1.c, atol=0)
    np.testing.assert_allclose(qp2.lvar, qp1.lvar)
    np.testing.assert_allclose(qp2.uvar, qp1.uvar)
    np.testing.assert_allclose(qp2.lcon, qp1.lcon)
    np.testing.assert_allclose(qp2.ucon, qp1.ucon)
    np.testing.assert_allclose(qp2.A.toarray(), qp1.A.toarray())
    assert qp2.c0 == pytest.approx(qp1.c0)
    assert qp2.minimize == qp1.minimize
    if qp1.H is not None:
        np.testing.assert_allclose(qp2.H.toarray(), qp1.H.toarray())
    s1 = mq.solve(qp1, **QUIET)
    s2 = mq.solve(qp2, **QUIET)
    assert s2.objective == pytest.approx(s1.objective, abs=1e-8)
