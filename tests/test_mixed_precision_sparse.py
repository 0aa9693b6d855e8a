"""Sparse mixed precision: pivot-floored f32 LDL + two-phase f64 endgame.

Plain f32 Cholesky of the normal equations breaks (negative pivots) from
n≈4000 as the barrier diagonal spans 1e±8, and f32 factors of a cond>1e7
system stall short of tol=1e-8 no matter how many refinement steps are
applied.  The shipped scheme: f32 phase with cuDSS-style pivot
perturbation to phase1_tol, then a warm-started f64 endgame
(precision_scheme='two-phase', utils/options.py)."""

import numpy as np
import pytest

import madqp_tpu as mq


@pytest.fixture(scope="module")
def banded():
    return mq.banded_sparse_lp(n=4000, m=2000, band=5, seed=0)


def test_lp_two_phase_reaches_tol(banded):
    st = mq.solve_sparse_lp(banded, tol=1e-8, print_level=0,
                            factorization_dtype="float32",
                            max_refine_steps=2)
    ref = mq.solve_sparse_lp(banded, tol=1e-8, print_level=0)
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert st.primal_feas < 1e-8 and st.dual_feas < 1e-8
    assert st.objective == pytest.approx(ref.objective, rel=1e-9)
    # phase-1 + phase-2 iterations should stay near the f64 count
    assert st.iter <= ref.iter + 6


def test_lp_simple_scheme_does_not_crash(banded):
    """precision_scheme='simple' keeps the old single-phase behavior:
    the pivot floor prevents hard factorization failure (status 6) even
    where it cannot reach 1e-8."""
    st = mq.solve_sparse_lp(banded, tol=1e-8, print_level=0, max_iter=40,
                            factorization_dtype="float32",
                            max_refine_steps=2,
                            precision_scheme="simple")
    assert st.status in (mq.Status.SOLVE_SUCCEEDED,
                         mq.Status.MAXIMUM_ITERATIONS_EXCEEDED)


def test_qp_two_phase_matches_f64():
    from madqp_tpu.models.suite import svm_qp

    qp = svm_qp(200, 30, seed=1)
    st = mq.solve_sparse_qp(qp, tol=1e-8, print_level=0,
                            factorization_dtype="float32",
                            max_refine_steps=2)
    ref = mq.solve_sparse_qp(qp, tol=1e-8, print_level=0)
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert st.objective == pytest.approx(ref.objective, rel=1e-7)


def test_two_phase_disabled_when_tol_loose(banded):
    """tol >= phase1_tol runs single-phase (no pointless f64 endgame)."""
    st = mq.solve_sparse_lp(banded, tol=1e-3, print_level=0,
                            factorization_dtype="float32",
                            max_refine_steps=2)
    assert st.status == mq.Status.SOLVE_SUCCEEDED


def test_driver_two_phase_python_loop(banded):
    """The host-stepped loop (loop_mode='python', used for verbose /
    wall-time-limited solves) chains the same f32→f64 two-phase scheme
    as the jitted path (driver._run_python_loop)."""
    st = mq.MPCSolver(banded, kkt_system="sparse-normal", tol=1e-8,
                      print_level=40, loop_mode="python",
                      factorization_dtype="float32",
                      max_refine_steps=2).solve()
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert st.primal_feas < 1e-8 and st.dual_feas < 1e-8


def test_driver_two_phase_sparse_normal(banded):
    """MPCSolver with kkt_system='sparse-normal' + f32 also runs the
    two-phase scheme (driver._bind_kernel)."""
    st = mq.MPCSolver(banded, kkt_system="sparse-normal", tol=1e-8,
                      print_level=40, factorization_dtype="float32",
                      max_refine_steps=2).solve()
    ref = mq.MPCSolver(banded, kkt_system="sparse-normal", tol=1e-8,
                       print_level=40).solve()
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert st.primal_feas < 1e-8 and st.dual_feas < 1e-8
    assert st.objective == pytest.approx(ref.objective, rel=1e-9)


class TestKrylovEndgame:
    """endgame='krylov': the f32 factor preconditions f64 CG
    instead of refactorizing in f64; iterates must match the f64 endgame."""

    def test_lp_matches_f64_endgame(self):
        import madqp_tpu as mq
        from madqp_tpu.models.generators import grid_lp

        qp = grid_lp(g=12, seed=0)
        kw = dict(print_level=40, factorization_dtype="float32",
                  max_refine_steps=1, tol=1e-8)
        a = mq.solve_sparse_lp(qp, endgame="f64", **kw)
        b = mq.solve_sparse_lp(qp, endgame="krylov", **kw)
        assert a.status == b.status == mq.Status.SOLVE_SUCCEEDED
        assert b.iter == a.iter
        assert b.objective == pytest.approx(a.objective, rel=1e-10)
        assert b.primal_feas < 1e-8 and b.dual_feas < 1e-8

    def test_condensed_krylov(self):
        import madqp_tpu as mq
        import numpy as np
        import scipy.sparse as sp

        rng = np.random.default_rng(0)
        n, m = 120, 240
        H = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.5),
                      np.full(n - 1, -1.0)], (-1, 0, 1), format="csr")
        A = sp.random(m, n, density=0.05,
                      random_state=np.random.RandomState(1),
                      data_rvs=lambda k: rng.uniform(0.5, 1.5, k)).tocsr()
        x_f = rng.uniform(0.2, 0.8, n)
        mid = np.asarray(A @ x_f).ravel()
        qp = mq.QuadraticProblem(
            c=rng.standard_normal(n), H=H, A=A,
            lcon=mid - 1.0, ucon=mid + 1.0,
            lvar=np.zeros(n), uvar=np.ones(n))
        kw = dict(print_level=40, factorization_dtype="float32",
                  max_refine_steps=1, tol=1e-8)
        a = mq.solve_sparse_condensed(qp, endgame="f64", **kw)
        b = mq.solve_sparse_condensed(qp, endgame="krylov", **kw)
        assert a.status == b.status == mq.Status.SOLVE_SUCCEEDED
        assert b.objective == pytest.approx(a.objective, rel=1e-8)


class TestHostEndgame:
    """endgame='host': the last iterations run on the host C++ LDL path,
    warm-started from the device f32 iterate — the f64 XLA program (the
    dominant cold-compile cost) never compiles."""

    def test_lp_matches_f64_endgame(self):
        import madqp_tpu as mq
        from madqp_tpu.models.generators import grid_lp

        qp = grid_lp(g=12, seed=0)
        kw = dict(print_level=40, factorization_dtype="float32",
                  max_refine_steps=1, tol=1e-8)
        a = mq.solve_sparse_lp(qp, endgame="f64", **kw)
        b = mq.solve_sparse_lp(qp, endgame="host", **kw)
        assert a.status == b.status == mq.Status.SOLVE_SUCCEEDED
        assert b.objective == pytest.approx(a.objective, rel=1e-9)
        assert b.primal_feas < 1e-8 and b.dual_feas < 1e-8

    def test_qp_augmented_host_endgame(self):
        import madqp_tpu as mq
        from madqp_tpu.models.suite import chain_qp

        qp = chain_qp(120, seed=0)
        kw = dict(print_level=40, factorization_dtype="float32",
                  max_refine_steps=1, tol=1e-8)
        a = mq.solve_sparse_qp(qp, **kw)
        b = mq.solve_sparse_qp(qp, endgame="host", **kw)
        assert a.status == b.status == mq.Status.SOLVE_SUCCEEDED
        assert b.objective == pytest.approx(a.objective, rel=1e-8)

    def test_host_warm_start_internal(self):
        # a warm start at the solution must converge in very few iterations
        import madqp_tpu as mq
        import numpy as np
        from madqp_tpu.solver.host import HostMPCSolver

        qp = mq.random_lp(60, 24, seed=2)
        ref = HostMPCSolver(qp, print_level=40, tol=1e-8).solve()
        assert ref.status == mq.Status.SOLVE_SUCCEEDED
        cold_iters = ref.iter
        h2 = HostMPCSolver(qp, print_level=40, tol=1e-8)
        # map the user solution into internal coords via the std transform
        info = h2.info
        n, m = h2.prob.n, h2.prob.m
        x_int = np.zeros(n)
        x_int[: info.n_kept] = ref.solution[info.keep_idx]
        s = h2.std.A[:, : info.n_kept] @ x_int[: info.n_kept]
        # slack block: A_int = [A_kept, -I] on inequality rows
        if n > info.n_kept:
            x_int[info.n_kept:] = np.asarray(
                h2.std.A[info.ineq_rows][:, : info.n_kept]
                @ x_int[: info.n_kept]).ravel()
        y_int = ref.multipliers * info.obj_scale / np.maximum(
            info.con_scale, 1e-300)
        h2.set_initial_point_internal(
            x_int, y_int, np.ones(n), np.ones(n))
        warm = h2.solve()
        assert warm.status == mq.Status.SOLVE_SUCCEEDED
        assert warm.iter <= cold_iters
        assert warm.objective == pytest.approx(ref.objective, abs=1e-6)


def test_phase1_max_iter_caps_f32_phase():
    """phase1_max_iter bounds the f32 phase wherever a rescue phase
    exists (options.py) — stall detection misses oscillating lanes,
    which otherwise burn the full max_iter in lockstep before rescue."""
    from madqp_tpu.solver.sparse_common import two_phase_opts
    from madqp_tpu.utils.options import IPMOptions

    opts = IPMOptions(factorization_dtype="float32", max_iter=300)
    o1, o2 = two_phase_opts(opts)
    assert o1.max_iter == opts.phase1_max_iter == 80
    assert o2.max_iter == 300          # endgame keeps the user's budget
    assert o1.stall_exit == 5

    # a user budget below the cap wins
    o1, _ = two_phase_opts(IPMOptions(factorization_dtype="float32",
                                      max_iter=40))
    assert o1.max_iter == 40


def test_illscaled_iteration_parity_vs_host():
    """illscaled_500 took 55-79 device iterations vs 12-13 on host before
    the phase1_max_iter/stall fixes.  Pin the trajectory-parity bar
    (device-path iters <= 2x host) on the family the
    f32 phase used to blow up on.  (Reference: same algorithm => same
    counts, test/runtests.jl:102-115.)"""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import illscaled_lp

    qp = illscaled_lp(200, seed=0)
    qp_p, _, ok = mq.presolve_qp(qp)
    assert ok
    qp_s, _ = mq.scale_qp(qp_p)
    common = dict(tol=1e-8, max_iter=300, max_ncorr=3, print_level=0,
                  step_rule=mq.AdaptiveStep(0.995),
                  regularization=mq.FixedRegularization(1e-8, -1e-8))
    host = mq.solve_host(qp_s, **common)
    assert host.status == mq.Status.SOLVE_SUCCEEDED
    mixed = mq.solve_sparse_lp(qp_s, factorization_dtype="float32",
                               max_refine_steps=1, endgame="host", **common)
    assert mixed.status == mq.Status.SOLVE_SUCCEEDED
    assert mixed.iter <= 2 * host.iter


def test_measure_linear_solver_sparse_paths():
    """options.measure_linear_solver fills counters.linear_solver_time on
    the sparse drivers (the column must be measured or absent, never a
    0.0 placeholder); without it the two-phase host
    endgame must NOT leak its partial (endgame-only) accumulation."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import staircase_lp

    qp = staircase_lp(40, 8, seed=2)
    qp_p, _, ok = mq.presolve_qp(qp)
    assert ok
    qp_s, _ = mq.scale_qp(qp_p)
    common = dict(tol=1e-8, print_level=0, factorization_dtype="float32",
                  max_refine_steps=1, endgame="host")
    st = mq.solve_sparse_lp(qp_s, measure_linear_solver=True, **common)
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert 0.0 < st.counters.linear_solver_time < st.counters.total_time
    st0 = mq.solve_sparse_lp(qp_s, **common)
    assert st0.counters.linear_solver_time == 0.0  # partial scope zeroed
