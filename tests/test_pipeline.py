"""Problem-preparation pipeline tests: MPS/QPS reader, Ruiz scaling,
presolve (reference L5, scripts/common.jl)."""

import gzip
import textwrap

import numpy as np
import pytest

import madqp_tpu as mq
from madqp_tpu.io.mps import parse_mps, read_mps
from madqp_tpu.models.presolve import PresolveStatus, presolve_qp
from madqp_tpu.models.scaling import ruiz_scaling_factors, scale_qp, unscale_stats

import io as _io

# AFIRO-style tiny LP with every major MPS feature.
MPS_LP = textwrap.dedent("""\
    * test problem
    NAME          TESTLP
    ROWS
     N  COST
     L  LIM1
     G  LIM2
     E  MYEQN
    COLUMNS
        X1        COST            1.0   LIM1            1.0
        X1        LIM2            1.0
        X2        COST            2.0   LIM1            1.0
        X2        MYEQN          -1.0
        X3        COST           -1.0   MYEQN           1.0
    RHS
        RHS       LIM1            4.0   LIM2            1.0
        RHS       MYEQN           7.0
    RANGES
        RNG       LIM1            2.5
    BOUNDS
     UP BND       X1              4.0
     LO BND       X2             -1.0
    ENDATA
    """)

MPS_QP = textwrap.dedent("""\
    NAME          TESTQP
    ROWS
     N  obj
     G  c1
    COLUMNS
        x1        obj             2.0   c1              1.0
        x2        obj             3.0   c1              1.0
    RHS
        rhs       c1              1.0   obj            -1.5
    BOUNDS
     FR BND       x1
     FR BND       x2
    QUADOBJ
        x1        x1              8.0
        x1        x2              2.0
        x2        x2             10.0
    ENDATA
    """)


class TestMPSReader:
    def test_parse_lp(self):
        qp = parse_mps(_io.StringIO(MPS_LP))
        assert qp.name == "TESTLP"
        assert qp.nvar == 3 and qp.ncon == 3
        np.testing.assert_allclose(qp.c, [1.0, 2.0, -1.0])
        A = qp.A.toarray()
        np.testing.assert_allclose(A, [[1, 1, 0], [1, 0, 0], [0, -1, 1]])
        # L row with RANGES 2.5: [4 - 2.5, 4]
        np.testing.assert_allclose(qp.lcon, [1.5, 1.0, 7.0])
        np.testing.assert_allclose(qp.ucon, [4.0, np.inf, 7.0])
        np.testing.assert_allclose(qp.lvar, [0.0, -1.0, 0.0])
        np.testing.assert_allclose(qp.uvar, [4.0, np.inf, np.inf])

    def test_parse_qp_and_objective_constant(self):
        qp = parse_mps(_io.StringIO(MPS_QP))
        assert qp.nnzh > 0
        H = qp.H.toarray()
        np.testing.assert_allclose(H, [[8.0, 2.0], [2.0, 10.0]])
        # RHS on the objective row: c0 = -(-1.5) = 1.5
        assert qp.c0 == pytest.approx(1.5)

    def test_roundtrip_solve(self):
        qp = parse_mps(_io.StringIO(MPS_QP))
        stats = mq.solve(qp, print_level=40)
        assert stats.status == mq.Status.SOLVE_SUCCEEDED
        # min x'Hx/2 + 2x1 + 3x2 + 1.5 s.t. x1 + x2 >= 1: KKT by hand
        H = qp.H.toarray()
        # active constraint: solve [H A'; A 0] [x; -y] = [-c; 1]
        K = np.block([[H, np.ones((2, 1))], [np.ones((1, 2)), np.zeros((1, 1))]])
        sol = np.linalg.solve(K, np.array([-2.0, -3.0, 1.0]))
        np.testing.assert_allclose(stats.solution, sol[:2], atol=1e-6)

    def test_gzip_reader(self, tmp_path):
        path = tmp_path / "test.mps.gz"
        with gzip.open(path, "wt") as f:
            f.write(MPS_LP)
        qp = read_mps(str(path))
        assert qp.nvar == 3

    def test_garbage_file_rejected(self):
        # Arbitrary text must not parse as an empty "solved" problem.
        with pytest.raises(ValueError, match="no ROWS section"):
            parse_mps(_io.StringIO("GARBAGE\nNOT AN MPS\n"))

    def test_objsense_max(self):
        txt = MPS_LP.replace("NAME          TESTLP", "NAME  T\nOBJSENSE\n    MAX")
        qp = parse_mps(_io.StringIO(txt))
        assert not qp.minimize


class TestRuizScaling:
    def test_equilibration(self, rng):
        import scipy.sparse as sp

        A = sp.random(40, 60, density=0.1, random_state=7, format="csr")
        A.data = A.data * 10 ** rng.uniform(-4, 4, size=A.nnz)
        s = ruiz_scaling_factors(A, max_iter=50, tol=1e-6)
        B = sp.diags(1.0 / s.Dr) @ A @ sp.diags(1.0 / s.Dc)
        Babs = abs(B)
        rmax = Babs.max(axis=1).toarray().ravel()
        rmax = rmax[rmax > 0]
        cmax = Babs.max(axis=0).toarray().ravel()
        cmax = cmax[cmax > 0]
        assert np.all(np.abs(rmax - 1.0) < 1e-3)
        assert np.all(np.abs(cmax - 1.0) < 1e-3)

    def test_scaled_solve_unscales_to_same_solution(self):
        qp = mq.dense_dummy_qp(12, 6, seed=3)
        # Worsen conditioning artificially.
        qp.A = qp.A.multiply(1e3).tocsr()
        qp.lcon = qp.lcon * 1e3
        qp.ucon = qp.ucon * 1e3
        ref = mq.solve(qp, print_level=40)
        scaled, s = mq.scale_qp(qp)
        st = mq.solve(scaled, print_level=40)
        st = mq.unscale_stats(s, st)
        assert st.objective == pytest.approx(ref.objective, abs=1e-5)
        np.testing.assert_allclose(st.solution, ref.solution, atol=1e-4)
        np.testing.assert_allclose(st.multipliers, ref.multipliers, atol=1e-4)


def _check_kkt(qp, x, y, zl, zu, tol=1e-6):
    """Original-space KKT check under the solver convention
    g + A'y - zl + zu = 0 (sign-flipped multipliers for maximize)."""
    sign = 1.0 if qp.minimize else -1.0
    g = qp.c + (qp.H @ x if qp.H is not None else 0.0)
    stat = sign * g + sign * (qp.A.T @ y) - sign * zl + sign * zu
    assert np.abs(stat).max() < tol, f"stationarity {np.abs(stat).max():.2e}"
    assert np.all(sign * zl >= -tol) and np.all(sign * zu >= -tol)
    r = np.asarray(qp.A @ x).ravel()
    assert np.all(r >= qp.lcon - tol) and np.all(r <= qp.ucon + tol)
    assert np.all(x >= qp.lvar - tol) and np.all(x <= qp.uvar + tol)
    # complementarity of the bound duals
    fl, fu = np.isfinite(qp.lvar), np.isfinite(qp.uvar)
    gap_l = (x[fl] - qp.lvar[fl]) * sign * zl[fl]
    gap_u = (qp.uvar[fu] - x[fu]) * sign * zu[fu]
    assert np.abs(gap_l).max(initial=0) < tol
    assert np.abs(gap_u).max(initial=0) < tol


class TestPresolve:
    def test_empty_row_dropped(self):
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 1.0]),
            A=np.array([[1.0, 1.0], [0.0, 0.0]]),
            lcon=np.array([1.0, -1.0]),
            ucon=np.array([1.0, 1.0]),
            lvar=np.zeros(2),
            uvar=np.full(2, np.inf),
        )
        red, info, ok = presolve_qp(qp)
        if ok:
            assert info.status == PresolveStatus.REDUCED
            assert red.ncon == 1
            y = info.postsolve_y(np.array([5.0]))
            np.testing.assert_allclose(y, [5.0, 0.0])
        else:
            # duplicate-column merge + singleton row now solve this LP
            # entirely in presolve; the postsolved point must be optimal
            assert info.status == PresolveStatus.SOLVED
            x = info.postsolve_x(np.zeros(0))
            np.testing.assert_allclose(x.sum(), 1.0, atol=1e-9)
            assert qp.c @ x == pytest.approx(1.0, abs=1e-9)

    def test_empty_row_infeasible(self):
        qp = mq.QuadraticProblem(
            c=np.array([1.0]),
            A=np.array([[0.0]]),
            lcon=np.array([1.0]),
            ucon=np.array([2.0]),
            lvar=np.zeros(1),
            uvar=np.ones(1),
        )
        _, info, ok = presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.INFEASIBLE

    def test_eq_singleton_plus_empty_column_fully_solves(self):
        # row 0 is an equality singleton fixing x0 = 0.5; col 1 is empty
        # with c1 = -2 < 0 -> fixed at its upper bound 3.  Everything is
        # eliminated: the problem is SOLVED in presolve (the reference's
        # QuadraticModels.presolve does the same).
        qp = mq.QuadraticProblem(
            c=np.array([1.0, -2.0]),
            A=np.array([[1.0, 0.0]]),
            lcon=np.array([0.5]),
            ucon=np.array([0.5]),
            lvar=np.zeros(2),
            uvar=np.array([np.inf, 3.0]),
        )
        _, info, ok = presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.SOLVED
        x = info.postsolve_x(np.zeros(0))
        np.testing.assert_allclose(x, [0.5, 3.0])
        x, y, zl, zu = info.postsolve(np.zeros(0), np.zeros(0))
        _check_kkt(qp, x, y, zl, zu)

    def test_empty_column_unbounded(self):
        qp = mq.QuadraticProblem(
            c=np.array([1.0, -2.0]),
            A=np.array([[1.0, 0.0]]),
            lcon=np.array([0.5]),
            ucon=np.array([0.5]),
            lvar=np.zeros(2),
            uvar=np.full(2, np.inf),
        )
        _, info, ok = presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.UNBOUNDED

    def test_bound_crossing_infeasible(self):
        qp = mq.QuadraticProblem(
            c=np.array([1.0]),
            A=np.array([[1.0]]),
            lcon=np.array([0.0]), ucon=np.array([1.0]),
            lvar=np.array([2.0]), uvar=np.array([1.0]),
        )
        _, info, ok = presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.INFEASIBLE

    def test_eq_singleton_violating_bounds_infeasible(self):
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 1.0]),
            A=np.array([[2.0, 0.0], [1.0, 1.0]]),
            lcon=np.array([10.0, 1.0]), ucon=np.array([10.0, 2.0]),
            lvar=np.zeros(2), uvar=np.array([1.0, np.inf]),  # x0 = 5 > 1
        )
        _, info, ok = presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.INFEASIBLE

    def test_ineq_singleton_becomes_bound(self):
        # row 1: 2*x0 <= 3 -> x0 <= 1.5 (tighter than uvar=2), row dropped
        qp = mq.QuadraticProblem(
            c=np.array([-1.0, 1.0]),
            A=np.array([[1.0, 1.0], [2.0, 0.0]]),
            lcon=np.array([1.0, -np.inf]), ucon=np.array([np.inf, 3.0]),
            lvar=np.zeros(2), uvar=np.array([2.0, np.inf]),
        )
        red, info, ok = presolve_qp(qp)
        assert ok and red.ncon == 1 and red.nvar == 2
        assert red.uvar[0] == pytest.approx(1.5)
        ref = mq.solve(qp, print_level=40)
        st = mq.solve(red, print_level=40)
        st = info.postsolve_stats(st)
        assert st.objective == pytest.approx(ref.objective, abs=1e-7)
        _check_kkt(qp, st.solution, st.multipliers,
                   st.multipliers_L, st.multipliers_U)

    def test_free_column_singleton_substituted(self):
        # x2 free, appears only in the equality row 0 -> substituted out
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 2.0, 3.0]),
            A=np.array([[1.0, 1.0, 2.0], [1.0, -1.0, 0.0]]),
            lcon=np.array([4.0, -1.0]), ucon=np.array([4.0, 1.0]),
            lvar=np.array([0.0, 0.0, -np.inf]),
            uvar=np.array([np.inf, np.inf, np.inf]),
        )
        red, info, ok = presolve_qp(qp)
        assert ok
        assert red.nvar == 2 and red.ncon == 1
        ref = mq.solve(qp, print_level=40)
        st = mq.solve(red, print_level=40)
        st = info.postsolve_stats(st)
        assert st.objective == pytest.approx(ref.objective, abs=1e-7)
        _check_kkt(qp, st.solution, st.multipliers,
                   st.multipliers_L, st.multipliers_U)

    @pytest.mark.parametrize("with_h", [False, True], ids=["lp", "qp"])
    def test_planted_structure_postsolve_exact(self, with_h):
        """LP/QP with planted presolvable structure: fixed vars, eq/ineq
        singleton rows, an empty row, an empty column, a free column
        singleton.  presolve -> solve -> postsolve_stats must reproduce the
        direct solve and satisfy original-space KKT exactly."""
        rng = np.random.default_rng(7 + with_h)
        n_core, m_core = 12, 6
        A_core = rng.standard_normal((m_core, n_core))
        x_feas = rng.uniform(0.5, 1.5, n_core)
        b_core = A_core @ x_feas
        # assemble: [core | fixed | empty | free-singleton] columns
        n = n_core + 3
        m = m_core + 4  # + eq singleton, ineq singleton, empty, free-col row
        A = np.zeros((m, n))
        A[:m_core, :n_core] = A_core
        A[:m_core, n_core] = rng.standard_normal(m_core)  # fixed var col
        lcon = np.concatenate([b_core, [2.0, -np.inf, -1.0, 3.0]])
        ucon = np.concatenate([b_core, [2.0, 4.0, 1.0, 3.0]])
        A[m_core, 0] = 2.0          # eq singleton: x0 = 1
        A[m_core + 1, 1] = 4.0      # ineq singleton: x1 <= 1
        # row m_core+2 empty; row m_core+3: free column singleton (col n-1)
        A[m_core + 3, 2] = 1.0
        A[m_core + 3, n - 1] = 2.0  # free col: x_{n-1} = (3 - x2)/2
        lvar = np.full(n, 0.0)
        uvar = np.full(n, np.inf)
        lvar[n_core] = uvar[n_core] = 0.7       # fixed var
        lvar[n_core + 1], uvar[n_core + 1] = 0.0, 2.0  # empty col
        lvar[n - 1], uvar[n - 1] = -np.inf, np.inf     # free singleton col
        c = rng.uniform(0.5, 2.0, n)
        H = None
        if with_h:
            # diagonal H on the core block only (free col must stay linear)
            d = np.zeros(n)
            d[:n_core] = rng.uniform(0.1, 1.0, n_core)
            d[n_core] = 0.5   # fixed var with H entry: tests cross terms
            H = np.diag(d)
        qp = mq.QuadraticProblem(c=c, A=A, H=H, lcon=lcon, ucon=ucon,
                                 lvar=lvar, uvar=uvar)
        red, info, ok = presolve_qp(qp)
        assert ok and info.status == PresolveStatus.REDUCED
        assert red.nvar < n and red.ncon < m
        ref = mq.solve(qp, tol=1e-9, print_level=40)
        st = mq.solve(red, tol=1e-9, print_level=40)
        st = info.postsolve_stats(st)
        assert st.objective == pytest.approx(ref.objective, rel=1e-6)
        np.testing.assert_allclose(st.solution, ref.solution, atol=1e-5)
        _check_kkt(qp, st.solution, st.multipliers,
                   st.multipliers_L, st.multipliers_U)

    def test_maximize_postsolve(self):
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 1.0, 0.5]),
            A=np.array([[1.0, 1.0, 0.0], [0.0, 2.0, 0.0]]),
            lcon=np.array([-np.inf, 1.0]), ucon=np.array([3.0, 1.0]),
            lvar=np.zeros(3), uvar=np.array([np.inf, np.inf, 1.0]),
            minimize=False,
        )
        red, info, ok = presolve_qp(qp)
        # eq singleton fixes x1=0.5; row 0 becomes a singleton bound
        # x0 <= 2.5; both remaining cols empty -> fully SOLVED in presolve
        assert not ok and info.status == PresolveStatus.SOLVED
        ref = mq.solve(qp, print_level=40)
        x, y, zl, zu = info.postsolve(np.zeros(0), np.zeros(0))
        assert qp.obj(x) == pytest.approx(ref.objective, abs=1e-7)
        np.testing.assert_allclose(x, ref.solution, atol=1e-6)
        _check_kkt(qp, x, y, zl, zu)

    def test_chained_reductions_fixpoint(self):
        """Fixing a variable empties another row, which becomes a singleton
        chaining into another fix — requires the pass loop."""
        # x0 = 1 (eq singleton); then row1: x0 + x1 = 3 becomes singleton
        # fixing x1 = 2; then row2: x1 + x2 = 5 fixes x2 = 3.
        qp = mq.QuadraticProblem(
            c=np.ones(3),
            A=np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]),
            lcon=np.array([1.0, 3.0, 5.0]), ucon=np.array([1.0, 3.0, 5.0]),
            lvar=np.zeros(3), uvar=np.full(3, 10.0),
        )
        _, info, ok = presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.SOLVED
        x = info.postsolve_x(np.zeros(0))
        np.testing.assert_allclose(x, [1.0, 2.0, 3.0])
        x, y, zl, zu = info.postsolve(np.zeros(0), np.zeros(0))
        _check_kkt(qp, x, y, zl, zu)


class TestMPSRoundTrip:
    """write_mps -> read_mps -> solve must reproduce the original problem
    (writer is beyond the reference: QPSReader is read-only)."""

    @pytest.mark.parametrize("make", [
        lambda: mq.random_lp(25, 10, seed=4),
        lambda: mq.random_qp(20, 8, seed=5),
        lambda: mq.dense_dummy_qp(15, 6, seed=6),
    ], ids=["lp", "qp", "dummy"])
    def test_roundtrip(self, make, tmp_path):
        from madqp_tpu.io import write_mps

        qp = make()
        path = str(tmp_path / "rt.mps")
        write_mps(qp, path)
        qp2 = mq.read_mps(path)
        assert qp2.nvar == qp.nvar and qp2.ncon == qp.ncon
        a = mq.solve(qp, print_level=40)
        b = mq.solve(qp2, print_level=40)
        assert b.status == mq.Status.SOLVE_SUCCEEDED
        assert b.objective == pytest.approx(a.objective, abs=1e-6)
        np.testing.assert_allclose(b.solution, a.solution, atol=1e-5)


class TestActivityPresolve:
    """Row-activity reductions: bounds-implied rows drop (dual-exact y=0),
    activity-infeasible rows fail fast."""

    def test_redundant_row_dropped(self):
        import madqp_tpu as mq
        # x in [0,1]^2; row x1+x2 <= 5 is implied by the box
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 2.0]),
            A=np.array([[1.0, 1.0], [1.0, -1.0]]),
            lcon=np.array([-np.inf, 0.0]), ucon=np.array([5.0, 0.0]),
            lvar=np.zeros(2), uvar=np.ones(2),
        )
        red, info, ok = mq.presolve_qp(qp)
        assert ok and len(info.keep_rows) == 1
        st = mq.solve(red, print_level=0)
        full = info.postsolve_stats(st)
        # exact KKT on the original problem
        g = qp.c
        r = g + qp.A.T @ full.multipliers - full.multipliers_L \
            + full.multipliers_U
        assert np.max(np.abs(r)) < 1e-7
        ref = mq.solve(qp, print_level=0)
        assert full.objective == pytest.approx(ref.objective, abs=1e-8)

    def test_activity_infeasible(self):
        import madqp_tpu as mq
        # x in [0,1]^2 but x1+x2 >= 3: impossible
        qp = mq.QuadraticProblem(
            c=np.ones(2), A=np.array([[1.0, 1.0]]),
            lcon=np.array([3.0]), ucon=np.array([np.inf]),
            lvar=np.zeros(2), uvar=np.ones(2),
        )
        red, info, ok = mq.presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.INFEASIBLE


class TestDuplicateRows:
    def _qp(self, lcon2, ucon2, scale=2.0):
        import madqp_tpu as mq
        # row2 = scale * row1
        return mq.QuadraticProblem(
            c=np.array([1.0, -2.0]),
            A=np.array([[1.0, 1.0], [scale, scale], [1.0, -1.0]]),
            lcon=np.array([0.0, lcon2, -1.0]),
            ucon=np.array([1.5, ucon2, 1.0]),
            lvar=np.zeros(2), uvar=np.full(2, 2.0),
        )

    @pytest.mark.parametrize("lcon2,ucon2,scale", [
        (0.0, 2.0, 2.0),     # dropped row tighter on the upper side
        (-10.0, 30.0, 2.0),  # dropped row looser: pure drop
        (-2.4, -0.5, -2.0),  # negative scale: sides swap, t in [0.25, 1.2]
    ])
    def test_merge_and_exact_dual_postsolve(self, lcon2, ucon2, scale):
        import madqp_tpu as mq
        qp = self._qp(lcon2, ucon2, scale)
        red, info, ok = mq.presolve_qp(qp)
        assert ok and len(info.keep_rows) == 2
        st = mq.solve(red, print_level=0)
        full = info.postsolve_stats(st)
        ref = mq.solve(qp, print_level=0)
        assert full.objective == pytest.approx(ref.objective, abs=1e-7)
        # exact stationarity on the original problem
        r = qp.c + qp.A.T @ full.multipliers - full.multipliers_L \
            + full.multipliers_U
        assert np.max(np.abs(r)) < 1e-7
        # primal feasibility of every original row
        ax = qp.A @ full.solution
        assert np.all(ax >= qp.lcon - 1e-7)
        assert np.all(ax <= qp.ucon + 1e-7)

    def test_conflicting_duplicates_infeasible(self):
        import madqp_tpu as mq
        qp = self._qp(3.5, 10.0, 2.0)  # row1 <= 1.5 but 2*row1 >= 3.5
        red, info, ok = mq.presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.INFEASIBLE


class TestDuplicateRowEdgeCases:
    """Regressions from review: shifted-space bounds, inverted ranges,
    merge-then-eq-singleton interplay."""

    def _check_kkt(self, qp, info, st):
        full = info.postsolve_stats(st)
        r = qp.c + qp.A.T @ full.multipliers - full.multipliers_L \
            + full.multipliers_U
        assert np.max(np.abs(r)) < 1e-7
        ax = qp.A @ full.solution
        assert np.all(ax >= qp.lcon - 1e-7)
        assert np.all(ax <= qp.ucon + 1e-7)
        # complementarity: positive multiplier -> some row bound active
        for i, yi in enumerate(full.multipliers):
            if abs(yi) > 1e-7:
                slack = min(ax[i] - qp.lcon[i], qp.ucon[i] - ax[i])
                assert slack < 1e-6, (i, yi, slack)
        return full

    def test_parallel_only_after_fixed_elimination(self):
        import madqp_tpu as mq
        # x3 fixed; rows [1,1,-5] and [2,2,7] become parallel after its
        # elimination — binding-side detection must use original-space
        # activities, not shifted bounds.
        qp = mq.QuadraticProblem(
            c=np.array([1.0, -2.0, 0.0]),
            A=np.array([[1.0, 1.0, -5.0], [2.0, 2.0, 7.0]]),
            lcon=np.array([-5.0, 7.0]), ucon=np.array([-3.5, 9.0]),
            lvar=np.array([0.0, 0.0, 1.0]),
            uvar=np.array([2.0, 2.0, 1.0]),
        )
        red, info, ok = mq.presolve_qp(qp)
        assert ok
        st = mq.solve(red, print_level=0)
        full = self._check_kkt(qp, info, st)
        ref = mq.solve(qp, print_level=0)
        assert full.objective == pytest.approx(ref.objective, abs=1e-7)

    def test_inverted_range_within_tol_clamps(self):
        import madqp_tpu as mq
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 1.0]),
            A=np.array([[1.0, 1.0], [2.0, 2.0]]),
            lcon=np.array([0.0, 2.0 + 1e-11]),
            ucon=np.array([1.0, 4.0]),
            lvar=np.zeros(2), uvar=np.ones(2),
        )
        red, info, ok = mq.presolve_qp(qp)
        if ok:  # must produce a solvable problem, not lcon > ucon
            st = mq.solve(red, print_level=0)
            assert st.status == mq.Status.SOLVE_SUCCEEDED
        elif info.status == PresolveStatus.SOLVED:
            # fully reduced (dup rows clamp + dup cols merge + singleton):
            # the postsolved point must be primal feasible
            x = info.postsolve_x(np.zeros(0))
            r = np.asarray(qp.A @ x).ravel()
            assert np.all(r >= qp.lcon - 1e-8)
            assert np.all(r <= qp.ucon + 1e-8)
        else:
            assert info.status == PresolveStatus.INFEASIBLE

    def test_merge_then_eq_singleton_keep_row(self):
        import madqp_tpu as mq
        # rows [1,1] in [0,1.5] and equality [2,2]=2 merge to equality =1;
        # x2's fix then makes the keep row an eq singleton.  The recovered
        # multiplier must land on the equality row, not the slack one.
        qp = mq.QuadraticProblem(
            c=np.array([1.0, -2.0]),
            A=np.array([[1.0, 1.0], [2.0, 2.0]]),
            lcon=np.array([0.0, 2.0]), ucon=np.array([1.5, 2.0]),
            lvar=np.array([0.0, 0.3]), uvar=np.array([2.0, 0.3]),
        )
        red, info, ok = mq.presolve_qp(qp)
        assert ok or info.status == PresolveStatus.SOLVED
        if ok:
            st = mq.solve(red, print_level=0)
            full = self._check_kkt(qp, info, st)
        else:
            x = info.postsolve_x(np.zeros(len(info.keep_cols)))
            ax = qp.A @ x
            assert np.all(ax >= qp.lcon - 1e-9)
            assert np.all(ax <= qp.ucon + 1e-9)


class TestPresolveRound2:
    """Forcing rows, dominated columns, duplicate columns (
    QuadraticModels-presolve parity, reference scripts/common.jl:109-126),
    each with exact primal-dual postsolve."""

    def _solve_and_check(self, qp, tol=1e-6):
        red, info, ok = mq.presolve_qp(qp)
        if ok:
            st = mq.solve(red, print_level=0, tol=1e-9)
            assert st.status == mq.Status.SOLVE_SUCCEEDED
            full = info.postsolve_stats(st)
            x, y = full.solution, full.multipliers
            zl, zu = full.multipliers_L, full.multipliers_U
        else:
            assert info.status == PresolveStatus.SOLVED
            x, y, zl, zu = info.postsolve(
                np.zeros(0), np.zeros(len(info.keep_rows)))
        _check_kkt(qp, x, y, zl, zu, tol=tol)
        return x, y, zl, zu, info

    def test_forcing_row_lower(self):
        # x1 + x2 <= 0 with x >= 0 forces x1 = x2 = 0.
        qp = mq.QuadraticProblem(
            c=np.array([-1.0, -2.0, 1.0]),
            A=np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]),
            lcon=np.array([-np.inf, 1.0]),
            ucon=np.array([0.0, np.inf]),
            lvar=np.zeros(3), uvar=np.full(3, 5.0),
        )
        red, info, ok = mq.presolve_qp(qp)
        from madqp_tpu.models.presolve import _ForcingRow
        assert any(isinstance(op, _ForcingRow) for op in info.ops)
        x, y, zl, zu, _ = self._solve_and_check(qp)
        np.testing.assert_allclose(x[:2], 0.0, atol=1e-8)
        # the forcing row carries the dual weight for the negative costs
        assert y is not None

    def test_forcing_row_upper(self):
        # -x1 - x2 <= -10 with x <= 5: Umax = 10 == lcon(=10 after sign):
        # row x1 + x2 >= 10 with x <= 5 forces both at 5.
        qp = mq.QuadraticProblem(
            c=np.array([3.0, 4.0]),
            A=np.array([[1.0, 1.0]]),
            lcon=np.array([10.0]), ucon=np.array([np.inf]),
            lvar=np.zeros(2), uvar=np.full(2, 5.0),
        )
        x, y, zl, zu, info = self._solve_and_check(qp)
        np.testing.assert_allclose(x, [5.0, 5.0], atol=1e-9)
        # y must be >= min cost ratio so reduced costs are sign-correct
        from madqp_tpu.models.presolve import _ForcingRow
        assert any(isinstance(op, _ForcingRow) for op in info.ops)

    def test_dominated_column_fixed(self):
        # col0 and col1 parallel (alpha=1); c0 > c1 and col1 unbounded
        # above => col0 dominated, fixed at its lower bound.
        qp = mq.QuadraticProblem(
            c=np.array([2.0, 1.0, 1.0]),
            A=np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
            lcon=np.array([3.0, 1.0]), ucon=np.array([3.0, 1.0]),
            lvar=np.zeros(3), uvar=np.array([np.inf, np.inf, 2.0]),
        )
        x, y, zl, zu, info = self._solve_and_check(qp)
        assert x[0] == pytest.approx(0.0, abs=1e-7)
        assert x[1] == pytest.approx(3.0, abs=1e-7)

    def test_dominated_column_unbounded(self):
        # dominated col with infinite relevant bound => UNBOUNDED
        qp = mq.QuadraticProblem(
            c=np.array([-2.0, -1.0]),
            A=np.array([[1.0, 1.0]]),
            lcon=np.array([-np.inf]), ucon=np.array([4.0]),
            lvar=np.full(2, -np.inf), uvar=np.full(2, np.inf),
        )
        red, info, ok = mq.presolve_qp(qp)
        assert not ok and info.status == PresolveStatus.UNBOUNDED

    def test_duplicate_column_merge(self):
        # identical columns with identical costs merge; postsolve splits.
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 1.0, 2.0]),
            A=np.array([[1.0, 1.0, 1.0]]),
            lcon=np.array([5.0]), ucon=np.array([5.0]),
            lvar=np.zeros(3), uvar=np.array([2.0, 2.0, 10.0]),
        )
        red, info, ok = mq.presolve_qp(qp)
        from madqp_tpu.models.presolve import _MergeDupCol
        assert any(isinstance(op, _MergeDupCol) for op in info.ops)
        x, y, zl, zu, _ = self._solve_and_check(qp)
        # optimum: use the two cheap columns fully (2 + 2), then 1 of col2
        assert x[0] + x[1] == pytest.approx(4.0, abs=1e-7)
        assert x[2] == pytest.approx(1.0, abs=1e-7)
        assert qp.c @ x == pytest.approx(6.0, abs=1e-7)

    def test_duplicate_column_scaled(self):
        # col1 = 2 * col0 with c1 = 2 * c0: merge with alpha = 2.
        qp = mq.QuadraticProblem(
            c=np.array([1.0, 2.0]),
            A=np.array([[1.0, 2.0], [1.0, 2.0]])[:1],
            lcon=np.array([4.0]), ucon=np.array([4.0]),
            lvar=np.zeros(2), uvar=np.array([1.0, 3.0]),
        )
        x, y, zl, zu, _ = self._solve_and_check(qp)
        assert x[0] + 2 * x[1] == pytest.approx(4.0, abs=1e-8)
        assert qp.c @ x == pytest.approx(4.0, abs=1e-7)

    def test_random_lp_presolve_kkt_exact(self):
        # randomized regression: presolve+postsolve must preserve the KKT
        # system on LPs with mixed features
        for seed in range(4):
            qp = mq.random_lp(25, 10, seed=seed)
            self._solve_and_check(qp)
