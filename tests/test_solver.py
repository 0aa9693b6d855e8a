"""End-to-end solver tests mirroring the reference suite (test/runtests.jl).

Oracle patterns (SURVEY §4):
  1. cross-solver oracle — scipy (linprog / direct KKT solve) replaces the
     reference's stock MadNLPSolver;
  2. self-consistency oracle — one configuration produces a reference
     solution, all other configurations must reproduce it (including K2.5's
     iteration-identical requirement, test/runtests.jl:102-115).
"""

import numpy as np
import pytest
from scipy.optimize import linprog

import madqp_tpu as mq
from madqp_tpu import Status


QUIET = dict(print_level=40)


def scipy_lp_solve(qp):
    bounds = [
        (l if np.isfinite(l) else None, u if np.isfinite(u) else None)
        for l, u in zip(qp.lvar, qp.uvar)
    ]
    eq = qp.lcon == qp.ucon
    A = qp.A.toarray()
    res = linprog(
        qp.c,
        A_eq=A[eq] if eq.any() else None,
        b_eq=qp.lcon[eq] if eq.any() else None,
        A_ub=np.vstack([A[~eq], -A[~eq]]) if (~eq).any() else None,
        b_ub=np.concatenate([qp.ucon[~eq], -qp.lcon[~eq]]) if (~eq).any() else None,
        bounds=bounds,
        method="highs",
    )
    assert res.status == 0
    return res


class TestSimpleLP:
    """The reference's degenerate 2-variable LP (test/runtests.jl:139-181)."""

    def test_solve(self):
        stats = mq.solve(mq.simple_lp(), **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED
        assert stats.objective == pytest.approx(1.0, abs=1e-6)
        assert stats.solution == pytest.approx([0.5, 0.5], abs=1e-5)
        assert stats.constraints == pytest.approx([1.0], abs=1e-7)

    def test_normal_kkt_matches_reference_config(self):
        qp = mq.simple_lp()
        ref = mq.solve(qp, regularization=mq.NoRegularization(), **QUIET)
        sol = mq.solve(qp, kkt_system="normal", **QUIET)
        assert sol.status == Status.SOLVE_SUCCEEDED
        assert sol.objective == pytest.approx(ref.objective, abs=1e-6)
        np.testing.assert_allclose(sol.solution, ref.solution, atol=1e-6)
        np.testing.assert_allclose(sol.multipliers, ref.multipliers, atol=1e-6)


class TestDenseDummyQP:
    """Mirrors the DenseDummyQP block of the reference suite."""

    @pytest.mark.parametrize("n,m", [(10, 0), (10, 5), (50, 10)])
    def test_sizes(self, n, m):
        qp = mq.dense_dummy_qp(n, m, seed=n + m)
        stats = mq.solve(qp, **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED
        # KKT conditions at the solution (the cross-solver oracle):
        g = qp.grad(stats.solution)
        r = g + qp.jtprod(stats.multipliers) - stats.multipliers_L + stats.multipliers_U
        assert np.max(np.abs(r)) < 1e-5
        # primal feasibility
        c = qp.cons(stats.solution)
        assert np.all(c >= qp.lcon - 1e-6)
        assert np.all(c <= qp.ucon + 1e-6)
        assert np.all(stats.solution >= qp.lvar - 1e-6)
        assert np.all(stats.solution <= qp.uvar + 1e-6)

    @pytest.mark.parametrize("ncorr", [0, 5])
    def test_equality_constraints(self, ncorr):
        qp = mq.dense_dummy_qp(20, 15, equality_cons=(0, 1, 2, 7), seed=7)
        ref = mq.solve(qp, **QUIET)
        stats = mq.solve(qp, max_ncorr=ncorr, **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED
        assert stats.objective == pytest.approx(ref.objective, abs=1e-5)
        np.testing.assert_allclose(stats.solution, ref.solution, atol=1e-5)

    def test_fixed_variables(self):
        for eq in [(), (0, 1, 2, 7)]:
            qp = mq.dense_dummy_qp(20, 15, fixed_variables=(0, 1), equality_cons=eq, seed=11)
            stats = mq.solve(qp, **QUIET)
            assert stats.status == Status.SOLVE_SUCCEEDED
            assert stats.solution[0] == pytest.approx(qp.lvar[0], abs=1e-9)
            assert stats.solution[1] == pytest.approx(qp.lvar[1], abs=1e-9)
            # stationarity on the free variables
            g = qp.grad(stats.solution)
            r = (
                g + qp.jtprod(stats.multipliers)
                - stats.multipliers_L + stats.multipliers_U
            )
            free = np.ones(qp.nvar, bool)
            free[[0, 1]] = False
            assert np.max(np.abs(r[free])) < 1e-5

    @pytest.mark.parametrize(
        "rule",
        [
            mq.AdaptiveStep(0.99),
            mq.ConservativeStep(0.99),
            mq.MehrotraAdaptiveStep(0.99),
        ],
        ids=lambda r: type(r).__name__,
    )
    def test_step_rules(self, rule):
        qp = mq.dense_dummy_qp(10, 5, seed=5)
        stats = mq.solve(qp, step_rule=rule, **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED

    def test_k25_iteration_identical(self):
        """K2.5 must match the reference configuration exactly — including
        the iteration count (test/runtests.jl:102-115)."""
        qp = mq.dense_dummy_qp(10, 5, seed=5)
        ref = mq.solve(qp, regularization=mq.NoRegularization(), **QUIET)
        k25 = mq.solve(
            qp, regularization=mq.NoRegularization(), kkt_system="k2.5", **QUIET
        )
        assert k25.status == Status.SOLVE_SUCCEEDED
        assert k25.iter == ref.iter
        assert k25.objective == pytest.approx(ref.objective, abs=1e-6)
        np.testing.assert_allclose(k25.solution, ref.solution, atol=1e-6)
        np.testing.assert_allclose(k25.multipliers, ref.multipliers, atol=1e-6)

    @pytest.mark.parametrize(
        "reg",
        [
            mq.FixedRegularization(1e-8, -1e-9),
            mq.AdaptiveRegularization(1e-8, -1e-9, 1e-9),
        ],
        ids=lambda r: type(r).__name__,
    )
    def test_regularizations(self, reg):
        qp = mq.dense_dummy_qp(10, 5, seed=5)
        ref = mq.solve(qp, regularization=mq.NoRegularization(), **QUIET)
        sol = mq.solve(qp, regularization=reg, rethrow_error=True, **QUIET)
        assert sol.status == Status.SOLVE_SUCCEEDED
        assert sol.objective == pytest.approx(ref.objective, abs=1e-6)
        np.testing.assert_allclose(sol.solution, ref.solution, atol=1e-6)
        np.testing.assert_allclose(sol.multipliers, ref.multipliers, atol=1e-6)


class TestAgainstScipy:
    def test_random_lp_vs_linprog(self):
        qp = mq.random_lp(60, 25, seed=1)
        stats = mq.solve(qp, **QUIET)
        res = scipy_lp_solve(qp)
        assert stats.status == Status.SOLVE_SUCCEEDED
        assert stats.objective == pytest.approx(res.fun, abs=1e-6)

    def test_lp_with_ranges_vs_linprog(self):
        rng = np.random.default_rng(9)
        n, m = 30, 18
        A = rng.standard_normal((m, n))
        x_feas = rng.uniform(0.0, 1.0, size=n)
        mid = A @ x_feas
        qp = mq.QuadraticProblem(
            c=rng.standard_normal(n) + 1.0,
            A=A,
            lcon=mid - 0.3,
            ucon=mid + 0.3,
            lvar=np.zeros(n),
            uvar=np.full(n, 2.0),
        )
        stats = mq.solve(qp, **QUIET)
        res = scipy_lp_solve(qp)
        assert stats.status == Status.SOLVE_SUCCEEDED
        assert stats.objective == pytest.approx(res.fun, abs=1e-6)

    def test_eq_qp_vs_direct_kkt(self):
        """Equality-constrained QP with inactive bounds has a closed-form
        KKT solution."""
        qp = mq.random_qp(30, 10, seed=3, ineq=False)
        stats = mq.solve(qp, **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED
        H = qp.H.toarray()
        A = qp.A.toarray()
        n, m = qp.nvar, qp.ncon
        Kmat = np.block([[H, A.T], [A, np.zeros((m, m))]])
        sol = np.linalg.solve(Kmat, np.concatenate([-qp.c, qp.lcon]))
        if np.all(sol[:n] > qp.lvar + 1e-6) and np.all(sol[:n] < qp.uvar - 1e-6):
            np.testing.assert_allclose(stats.solution, sol[:n], atol=1e-5)


class TestDriverBehavior:
    def test_max_iter(self):
        qp = mq.dense_dummy_qp(10, 5, seed=5)
        stats = mq.solve(qp, max_iter=1, **QUIET)
        assert stats.status == Status.MAXIMUM_ITERATIONS_EXCEEDED
        assert stats.iter == 1

    def test_python_loop_mode_matches_jit(self):
        qp = mq.dense_dummy_qp(10, 5, seed=5)
        a = mq.solve(qp, loop_mode="jit", **QUIET)
        b = mq.solve(qp, loop_mode="python", **QUIET)
        assert a.iter == b.iter
        assert a.objective == pytest.approx(b.objective, abs=1e-10)

    def test_no_scaling(self):
        qp = mq.dense_dummy_qp(10, 5, seed=5)
        stats = mq.solve(qp, scaling=False, **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED

    def test_solve_time_option_override(self):
        solver = mq.MPCSolver(mq.dense_dummy_qp(10, 5, seed=5), **QUIET)
        stats = solver.solve(max_iter=2)
        assert stats.status == Status.MAXIMUM_ITERATIONS_EXCEEDED

    def test_maximize(self):
        # max -(x1^2 + x2^2) + x1  s.t. 0 <= x <= 1  -> x = (0.5, 0)
        import scipy.sparse as sp

        qp = mq.QuadraticProblem(
            c=np.array([1.0, 0.0]),
            H=sp.csr_matrix(-np.eye(2) * 2.0),
            A=np.zeros((0, 2)),
            lcon=np.zeros(0),
            ucon=np.zeros(0),
            lvar=np.zeros(2),
            uvar=np.ones(2),
            minimize=False,
        )
        stats = mq.solve(qp, **QUIET)
        assert stats.status == Status.SOLVE_SUCCEEDED
        # max x1 - x1^2 - x2^2 on [0,1]^2 -> x = (0.5, 0), obj = 0.25
        assert stats.solution[0] == pytest.approx(0.5, abs=1e-4)
        assert stats.objective == pytest.approx(0.25, abs=1e-4)


class TestInfeasibilityDetection:
    """Detection the reference lacks (SURVEY §4: 'no infeasible/unbounded
    detection — the solver only stops on tol/max_iter')."""

    def _infeasible_lp(self):
        return mq.QuadraticProblem(
            c=np.ones(2),
            A=np.array([[1.0, 1.0], [1.0, 1.0]]),
            lcon=np.array([1.0, 2.0]),
            ucon=np.array([1.0, 2.0]),
            lvar=np.zeros(2),
            uvar=np.full(2, np.inf),
        )

    def test_primal_infeasible_lp(self):
        s = mq.solve(self._infeasible_lp(), max_iter=300, **QUIET)
        assert s.status == Status.INFEASIBLE_PROBLEM_DETECTED

    def test_unbounded_lp(self):
        qp = mq.QuadraticProblem(
            c=np.array([-1.0]), A=np.zeros((0, 1)), lcon=np.zeros(0),
            ucon=np.zeros(0), lvar=np.zeros(1), uvar=np.array([np.inf]),
        )
        s = mq.solve(qp, max_iter=300, **QUIET)
        assert s.status == Status.UNBOUNDED_PROBLEM_DETECTED

    def test_unbounded_lp_with_constraint(self):
        # min -x1-x2 s.t. x1-x2 = 0, x >= 0: unbounded along (1,1)
        qp = mq.QuadraticProblem(
            c=np.array([-1.0, -1.0]),
            A=np.array([[1.0, -1.0]]),
            lcon=np.zeros(1), ucon=np.zeros(1),
            lvar=np.zeros(2), uvar=np.full(2, np.inf),
        )
        s = mq.solve(qp, max_iter=300, **QUIET)
        assert s.status == Status.UNBOUNDED_PROBLEM_DETECTED

    def test_unbounded_qp_singular_hessian(self):
        # H singular along e2; objective -x2 unbounded along null(H)
        qp = mq.QuadraticProblem(
            c=np.array([0.0, -1.0]),
            A=np.zeros((0, 2)), lcon=np.zeros(0), ucon=np.zeros(0),
            lvar=np.array([0.0, 0.0]), uvar=np.full(2, np.inf),
            H=np.array([[1.0, 0.0], [0.0, 0.0]]),
        )
        s = mq.solve(qp, max_iter=300, **QUIET)
        assert s.status == Status.UNBOUNDED_PROBLEM_DETECTED

    def test_bounded_qp_not_flagged_unbounded(self):
        # same H but the descent direction is curved: bounded, solvable
        qp = mq.QuadraticProblem(
            c=np.array([-1.0, 0.0]),
            A=np.zeros((0, 2)), lcon=np.zeros(0), ucon=np.zeros(0),
            lvar=np.array([0.0, 0.0]), uvar=np.full(2, np.inf),
            H=np.array([[1.0, 0.0], [0.0, 1.0]]),
        )
        s = mq.solve(qp, max_iter=300, **QUIET)
        assert s.status == Status.SOLVE_SUCCEEDED

    def test_host_path_detects_unbounded(self):
        from madqp_tpu.solver.host import solve_host

        qp = mq.QuadraticProblem(
            c=np.array([-1.0, -1.0]),
            A=np.array([[1.0, -1.0]]),
            lcon=np.zeros(1), ucon=np.zeros(1),
            lvar=np.zeros(2), uvar=np.full(2, np.inf),
        )
        s = solve_host(qp, max_iter=300, **QUIET)
        assert s.status == Status.UNBOUNDED_PROBLEM_DETECTED

    def test_host_path_detects_infeasible(self):
        from madqp_tpu.solver.host import solve_host

        s = solve_host(self._infeasible_lp(), max_iter=300, **QUIET)
        assert s.status == Status.INFEASIBLE_PROBLEM_DETECTED

    def test_feasible_not_flagged(self):
        s = mq.solve(mq.dense_dummy_qp(15, 8, seed=9), **QUIET)
        assert s.status == Status.SOLVE_SUCCEEDED

    def test_farkas_certificate_upgrades_max_iter(self):
        """With max_iter too small for the divergence heuristic to fire,
        the exit-time Farkas check must certify infeasibility and upgrade
        MAXIMUM_ITERATIONS_EXCEEDED to INFEASIBLE_PROBLEM_DETECTED."""
        s = mq.solve(self._infeasible_lp(), max_iter=8, **QUIET)
        assert s.status == Status.INFEASIBLE_PROBLEM_DETECTED

    def test_farkas_not_fooled_by_hard_feasible(self):
        """A feasible problem stopped early must stay MAX_ITER: the final
        dual direction of a convergent run is no Farkas certificate."""
        qp = mq.dense_dummy_qp(30, 12, seed=3)
        s = mq.solve(qp, max_iter=2, **QUIET)
        assert s.status == Status.MAXIMUM_ITERATIONS_EXCEEDED

    def test_suite_multicommodity_feasible_all_seeds(self):
        """Regression: the shared-capacity draw used to produce certified-
        infeasible instances (nodes=10, ncomm=3, seed=1); capacities are
        now sized to admit a ring routing of every commodity."""
        from madqp_tpu.models.suite import multicommodity_lp

        for seed in range(3):
            qp = multicommodity_lp(8, 2, seed=seed)
            qp_p, _, ok = mq.presolve_qp(qp)
            assert ok
            qp_s, _ = mq.scale_qp(qp_p)
            s = mq.solve(qp_s, tol=1e-8, **QUIET)
            assert s.status == Status.SOLVE_SUCCEEDED, seed


class TestBucketedPadding:
    """pad_mode='bucket' pads to shape buckets (ragged-suite compile
    amortization, SURVEY §7.3) without changing results."""

    def test_matches_unpadded(self):
        qp = mq.dense_dummy_qp(13, 6, seed=17)
        a = mq.solve(qp, pad_mode="bucket", **QUIET)
        b = mq.solve(qp, **QUIET)
        assert a.status == Status.SOLVE_SUCCEEDED
        assert a.objective == pytest.approx(b.objective, abs=1e-7)
        np.testing.assert_allclose(a.solution, b.solution, atol=1e-6)
        np.testing.assert_allclose(a.multipliers, b.multipliers, atol=1e-6)
        assert len(a.solution) == qp.nvar
        assert len(a.multipliers) == qp.ncon

    def test_same_bucket_shares_compile(self):
        # Two same-bucket instances must produce correct results through the
        # shared jitted kernel (lru-cached by options).
        for seed in (21, 22):
            qp = mq.dense_dummy_qp(10 + seed % 3, 5, seed=seed)
            s = mq.solve(qp, pad_mode="bucket", **QUIET)
            assert s.status == Status.SOLVE_SUCCEEDED


class TestWarmStart:
    """Warm starting (beyond the reference): re-solving from a previous
    solution converges in fewer iterations."""

    def test_warm_from_solution(self):
        qp = mq.dense_dummy_qp(25, 12, seed=8)
        cold = mq.solve(qp, **QUIET)
        solver = mq.MPCSolver(qp, **QUIET)
        solver.set_initial_point(
            x=cold.solution, y=cold.multipliers,
            zl=cold.multipliers_L, zu=cold.multipliers_U,
        )
        warm = solver.solve()
        assert warm.status == Status.SOLVE_SUCCEEDED
        assert warm.iter < cold.iter
        assert warm.objective == pytest.approx(cold.objective, abs=1e-6)

    def test_warm_perturbed_problem(self):
        """MPC-style scenario: warm start on a nearby problem."""
        qp1 = mq.dense_dummy_qp(25, 12, seed=8)
        sol1 = mq.solve(qp1, **QUIET)
        qp2 = mq.dense_dummy_qp(25, 12, seed=8)
        qp2.c = qp2.c + 0.01  # perturb objective
        cold = mq.solve(qp2, **QUIET)
        solver = mq.MPCSolver(qp2, **QUIET)
        solver.set_initial_point(
            x=sol1.solution, y=sol1.multipliers,
            zl=sol1.multipliers_L, zu=sol1.multipliers_U,
        )
        warm = solver.solve()
        assert warm.status == Status.SOLVE_SUCCEEDED
        assert warm.objective == pytest.approx(cold.objective, abs=1e-6)

    def test_warm_partial_point(self):
        """x-only warm start (duals default)."""
        qp = mq.dense_dummy_qp(20, 10, seed=12)
        cold = mq.solve(qp, **QUIET)
        solver = mq.MPCSolver(qp, **QUIET)
        solver.set_initial_point(x=cold.solution)
        warm = solver.solve()
        assert warm.status == Status.SOLVE_SUCCEEDED
        assert warm.objective == pytest.approx(cold.objective, abs=1e-6)

    def test_warm_fixed_variables(self):
        """Regression (review finding): slack mapping must exclude the
        eliminated fixed-variable columns."""
        qp = mq.dense_dummy_qp(12, 6, fixed_variables=(0, 1), seed=3)
        cold = mq.solve(qp, **QUIET)
        s = mq.MPCSolver(qp, **QUIET)
        s.set_initial_point(x=cold.solution, y=cold.multipliers,
                            zl=cold.multipliers_L, zu=cold.multipliers_U)
        warm = s.solve()
        assert warm.status == Status.SOLVE_SUCCEEDED
        assert warm.iter <= 2
        assert warm.objective == pytest.approx(cold.objective, abs=1e-6)

    def test_warm_maximize_sign(self):
        """Regression (review finding): z mapping must apply the objective
        sense sign (inverse of recover_z)."""
        import scipy.sparse as sp

        qp = mq.QuadraticProblem(
            c=np.array([1.0, 0.0]), H=sp.csr_matrix(-2.0 * np.eye(2)),
            A=np.zeros((0, 2)), lcon=np.zeros(0), ucon=np.zeros(0),
            lvar=np.zeros(2), uvar=np.ones(2), minimize=False,
        )
        cold = mq.solve(qp, **QUIET)
        s = mq.MPCSolver(qp, **QUIET)
        s.set_initial_point(x=cold.solution, y=cold.multipliers,
                            zl=cold.multipliers_L, zu=cold.multipliers_U)
        warm = s.solve()
        assert warm.status == Status.SOLVE_SUCCEEDED
        assert warm.iter <= 2

    def test_warm_respects_walltime(self):
        """Regression (review finding): the warm path must not bypass
        host-stepped execution modes."""
        qp = mq.dense_dummy_qp(25, 12, seed=8)
        cold = mq.solve(qp, **QUIET)
        s = mq.MPCSolver(qp, **QUIET)
        s.set_initial_point(x=cold.solution, y=cold.multipliers,
                            zl=cold.multipliers_L, zu=cold.multipliers_U)
        out = s.solve(max_wall_time=1e-9)
        assert out.status == Status.MAXIMUM_WALLTIME_EXCEEDED
        s.clear_initial_point()
        out2 = s.solve(max_wall_time=120.0)
        assert out2.status == Status.SOLVE_SUCCEEDED


class TestMixedPrecisionRescue:
    """Dense mixed precision chains a full-precision endgame on failure.

    The transportation LP has a rank-deficient equality block (supplies sum
    = demands sum), where the f32 condensed Schur complement stalls around
    1e-5 primal feasibility while f64 reaches 1e-8 (measured; the sparse
    paths hit the same wall).  The rescue must recover full
    tolerance without giving up the pure-f32 fast path on well-conditioned
    problems."""

    def test_rank_deficient_transport_rescued(self):
        from madqp_tpu.models.suite import transport_lp

        qp = transport_lp(12, 15, seed=0)
        qp_p, _, ok = mq.presolve_qp(qp)
        assert ok
        qp_s, _ = mq.scale_qp(qp_p)
        st = mq.solve(qp_s, tol=1e-8, max_ncorr=2,
                      factorization_dtype="float32", max_refine_steps=1,
                      **QUIET)
        assert st.status == Status.SOLVE_SUCCEEDED
        ref = mq.solve(qp_s, tol=1e-8, max_ncorr=2, **QUIET)
        assert st.objective == pytest.approx(ref.objective, rel=1e-8)
        # verbose (host-stepped) loop must rescue identically
        st_v = mq.solve(qp_s, tol=1e-8, max_ncorr=2, print_level=25,
                        factorization_dtype="float32", max_refine_steps=1)
        assert st_v.status == Status.SOLVE_SUCCEEDED

    def test_well_conditioned_stays_single_phase(self):
        qp = mq.random_qp(60, 24, seed=0, ineq=True)
        st32 = mq.solve(qp, tol=1e-8, factorization_dtype="float32",
                        max_refine_steps=1, **QUIET)
        st64 = mq.solve(qp, tol=1e-8, **QUIET)
        assert st32.status == Status.SOLVE_SUCCEEDED
        # f32+IR reproduces the f64 iterate path — if the
        # rescue phase had kicked in, the combined count would exceed it.
        assert st32.iter <= st64.iter + 1


class TestAutosolve:
    def test_routes_and_solves(self):
        small = mq.dense_dummy_qp(25, 10, seed=2)
        s1 = mq.autosolve(small, **QUIET)
        assert s1.status == Status.SOLVE_SUCCEEDED
        lp = mq.banded_sparse_lp(n=1800, m=900, seed=1)
        s2 = mq.autosolve(lp, **QUIET)
        assert s2.status == Status.SOLVE_SUCCEEDED
        ref = mq.solve_sparse_lp(lp, print_level=0)
        assert s2.objective == pytest.approx(ref.objective, rel=1e-7)
