"""Fully on-device sparse LP path (solver/sparse_lp.py).

Oracle strategy (SURVEY §4): the device sparse normal-equations KKT is
checked against the exact KKT residual equations, and the end-to-end
solve against the dense-path solver on the same problem (the reference's
self-consistency oracle, test/runtests.jl:95-135).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

import madqp_tpu as mq
from madqp_tpu.models.generators import banded_sparse_lp
from madqp_tpu.solver.sparse_lp import (
    DeviceSparseNormalKKT,
    SparseLPProblem,
    solve_sparse_lp,
)


def _make_problem(kkt, n, m):
    return SparseLPProblem(
        c0=jnp.zeros(()),
        c=jnp.zeros(n),
        b=jnp.zeros(m),
        has_lb=jnp.ones(n, bool),
        has_ub=jnp.zeros(n, bool),
        a_rows=jnp.asarray(kkt.coo_rows),
        a_cols=jnp.asarray(kkt.coo_cols),
        a_vals=jnp.asarray(kkt.coo_vals),
    )


@pytest.mark.parametrize("order,mode", [
    ("amd", "batched"), ("rcm", "batched"), ("amd", "unrolled"),
])
def test_device_normal_kkt_residual(order, mode):
    rng = np.random.default_rng(0)
    m, n = 40, 90
    A = sp.random(m, n, density=0.1, random_state=1, format="csr")
    A = A + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsr()
    # NOTE: CSR input — regression for the CSC/CSR data-ordering bug (the
    # pair contribution indices address the KKT's canonical CSC ordering).
    kkt = DeviceSparseNormalKKT(A, order=order, mode=mode)
    prob = _make_problem(kkt, n, m)

    pr_diag = jnp.asarray(rng.uniform(0.5, 2.0, n))
    del_c = -1e-8
    f = kkt.factorize(prob, pr_diag, del_c)
    assert bool(kkt.factor_ok(f))

    rx = jnp.asarray(rng.standard_normal(n))
    ry = jnp.asarray(rng.standard_normal(m))
    dx, dy = kkt.solve(f, rx, ry)

    Ad = A.toarray()
    r1 = np.asarray(pr_diag) * np.asarray(dx) + Ad.T @ np.asarray(dy) - np.asarray(rx)
    r2 = Ad @ np.asarray(dx) + del_c * np.asarray(dy) - np.asarray(ry)
    assert np.abs(r1).max() < 1e-10
    assert np.abs(r2).max() < 1e-10


def test_sparse_lp_matches_dense_solver():
    qp = banded_sparse_lp(n=160, m=80, band=4, seed=3)
    st = solve_sparse_lp(qp, tol=1e-8, print_level=0)
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status
    assert st.iter == ref.iter  # iteration-identical (same algorithm)
    assert abs(st.objective - ref.objective) <= 1e-7 * max(1.0, abs(ref.objective))
    np.testing.assert_allclose(st.solution, ref.solution, atol=1e-6)
    assert st.primal_feas < 1e-7
    assert st.dual_feas < 1e-7


def test_sparse_lp_rejects_qp():
    qp = mq.models.generators.random_qp(n=20, m=10, seed=0)
    with pytest.raises(ValueError):
        solve_sparse_lp(qp)


@pytest.mark.parametrize("make,arg", [
    ("grid3d_lp", 8), ("netflow_grid_lp", 14),
], ids=["grid3d", "netflow"])
def test_mesh_families_solve_to_optimality(make, arg):
    """Realistic mesh LPs (3D Laplacian, grid min-cost flow) solve on the
    on-device sparse path with order='auto' (ND on mesh normal matrices)."""
    qp = getattr(mq, make)(arg)
    st = mq.solve_sparse_lp(qp, tol=1e-8, print_level=40)
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert st.primal_feas < 1e-8 and st.dual_feas < 1e-8
    # cross-check the objective against the dense reference solver
    ref = mq.solve(qp, tol=1e-8, print_level=40)
    assert st.objective == pytest.approx(ref.objective, rel=1e-7)


class TestSparseCertificates:
    """Exit-time infeasible/unbounded certification on the sparse device
    drivers (shared finish_stats upgrade path)."""

    def test_sparse_infeasible_lp(self):
        qp = mq.QuadraticProblem(
            c=np.ones(2),
            A=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]])),
            lcon=np.array([1.0, 2.0]), ucon=np.array([1.0, 2.0]),
            lvar=np.zeros(2), uvar=np.full(2, np.inf),
        )
        st = solve_sparse_lp(qp, max_iter=300, print_level=0)
        assert st.status == mq.Status.INFEASIBLE_PROBLEM_DETECTED

    def test_sparse_unbounded_lp(self):
        qp = mq.QuadraticProblem(
            c=np.array([-1.0, -1.0]),
            A=sp.csr_matrix(np.array([[1.0, -1.0]])),
            lcon=np.zeros(1), ucon=np.zeros(1),
            lvar=np.zeros(2), uvar=np.full(2, np.inf),
        )
        st = solve_sparse_lp(qp, max_iter=300, print_level=0)
        assert st.status == mq.Status.UNBOUNDED_PROBLEM_DETECTED


def test_dense_normal_mode_matches_host():
    """mode='dense' (small-m dense-normal factorization, the latency fix
    for m <= dense_normal_limit) must reproduce the host
    trajectory iteration-for-iteration in f64."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import staircase_lp

    qp = staircase_lp(20, 8, seed=0)
    qp_p, _, ok = mq.presolve_qp(qp)
    assert ok
    qp_s, _ = mq.scale_qp(qp_p)
    common = dict(tol=1e-8, max_iter=300, max_ncorr=3, print_level=0,
                  step_rule=mq.AdaptiveStep(0.995),
                  regularization=mq.FixedRegularization(1e-8, -1e-8))
    h = mq.solve_host(qp_s, **common)
    d = mq.solve_sparse_lp(qp_s, mode="dense", **common)
    assert d.status == mq.Status.SOLVE_SUCCEEDED
    assert d.iter == h.iter
    assert d.objective == pytest.approx(h.objective, rel=1e-9)


def test_dense_normal_mode_mixed_precision():
    """f32 dense-normal rides the pivot-floored LDL (not plain Cholesky,
    which goes negative on degenerate normal matrices near convergence)."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import assignment_lp

    qp = assignment_lp(15, seed=0)
    qp_p, _, ok = mq.presolve_qp(qp)
    assert ok
    qp_s, _ = mq.scale_qp(qp_p)
    st = mq.solve_sparse_lp(qp_s, mode="dense",
                            factorization_dtype="float32",
                            max_refine_steps=1, endgame="host",
                            tol=1e-8, print_level=0,
                            regularization=mq.FixedRegularization(1e-8, -1e-8))
    assert st.status == mq.Status.SOLVE_SUCCEEDED


def test_dense_columns_endgame_rides_k2():
    """Dense-column patterns (svm-like) force matmul assembly; the host
    endgame must then hand over to the K2 augmented system — the host's
    sparse LDL on the DENSE normal pattern pays O(m^3) inside CSC
    (measured 61-70 s of endgame linear-solver time on svm m=3000 in the
    first round-4 xlarge artifact)."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import svm_qp
    from madqp_tpu.solver import sparse_lp as SL
    from madqp_tpu.solver import sparse_qp as SQ

    qp = svm_qp(300, 40, seed=0)
    qp_p, _, ok = mq.presolve_qp(qp)
    assert ok
    qp_s, sc = mq.scale_qp(qp_p)

    seen = {}
    orig = SQ._host_endgame

    def spy(qp_, opts, final, info, std, t0, kkt_system="k2"):
        seen["kkt"] = kkt_system
        return orig(qp_, opts, final, info, std, t0, kkt_system=kkt_system)

    # svm_300x40 is below the 2e7 pair threshold, so force matmul
    # assembly the same way the real svm_3000x200 triggers it.
    orig_init = SL.DeviceSparseNormalKKT.__init__

    def forced(self, A, **kw):
        orig_init(self, A, **kw)
        if kw.get("mode") == "dense":
            self.assembly = "matmul"
            self.symb = None
            self.value_gather = None
    SL.DeviceSparseNormalKKT.__init__ = forced
    SQ._host_endgame = spy
    try:
        st = mq.solve_sparse_lp(
            qp_s, mode="dense", factorization_dtype="float32",
            max_refine_steps=1, endgame="host", tol=1e-8, print_level=0,
            regularization=mq.FixedRegularization(1e-8, -1e-8))
    finally:
        SQ._host_endgame = orig
        SL.DeviceSparseNormalKKT.__init__ = orig_init
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert seen["kkt"] == "k2"


def test_dense_mode_defaults_to_jit_loop():
    """loop_mode='auto' runs dense-normal solves as bounded-chunk
    while_loop dispatches (chunked_solve) — never the per-iteration
    stepped loop, which pays a host sync per iteration."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import staircase_lp
    from madqp_tpu.solver import sparse_common as SC

    qp = staircase_lp(20, 8, seed=1)
    qp_p, _, ok = mq.presolve_qp(qp)
    assert ok
    qp_s, _ = mq.scale_qp(qp_p)

    # Patch the functions on sparse_common itself: solve_sparse_lp binds
    # them via function-level `from .sparse_common import ...` at call
    # time, so a spy installed on the sparse_lp module namespace never
    # fires (advisor round-4: the old form was vacuous).
    called = {"stepped": 0, "chunked": 0}
    orig_stepped, orig_chunked = SC.stepped_solve, SC.chunked_solve

    def spy_stepped(*a, **kw):
        called["stepped"] += 1
        return orig_stepped(*a, **kw)

    def spy_chunked(*a, **kw):
        called["chunked"] += 1
        return orig_chunked(*a, **kw)

    SC.stepped_solve = spy_stepped
    SC.chunked_solve = spy_chunked
    try:
        st = mq.solve_sparse_lp(qp_s, mode="dense", tol=1e-8,
                                print_level=0)
    finally:
        SC.stepped_solve = orig_stepped
        SC.chunked_solve = orig_chunked
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert called["stepped"] == 0
    assert called["chunked"] == 1


def test_schedule_cap_falls_back_to_host(monkeypatch):
    """High-fill guard (laplqp post-mortem): when the flat
    scatter-map schedule would exceed MADQP_MAX_UPDATE_ENTRIES, the
    sparse device drivers run the WHOLE solve on the host path (visible
    as endgame_backend='host-full') instead of building a schedule that
    OOM-kills the process."""
    import madqp_tpu as mq
    from madqp_tpu.models.generators import banded_sparse_lp

    monkeypatch.setenv("MADQP_MAX_UPDATE_ENTRIES", "10")
    qp = banded_sparse_lp(n=400, m=200, band=5, seed=3)
    # mode='batched' forces the supernodal schedule (m=200 would route
    # to dense-normal mode, which builds no schedule at all)
    st = mq.solve_sparse_lp(qp, mode="batched", tol=1e-8, print_level=0)
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    assert st.counters.endgame_backend == "host-full"
    assert st.counters.endgame_time == st.counters.total_time


def test_schedule_cap_error_type():
    from madqp_tpu.ops.sparse_chol import ScheduleTooLargeError, \
        analyze_batched
    import os
    import pytest
    import scipy.sparse as sp
    import numpy as np

    os.environ["MADQP_MAX_UPDATE_ENTRIES"] = "10"
    try:
        rng = np.random.default_rng(0)
        M = sp.random(300, 300, density=0.05,
                      random_state=np.random.RandomState(0))
        S = (M @ M.T + sp.eye(300)).tocsc()
        with pytest.raises(ScheduleTooLargeError):
            analyze_batched(S, order="amd")
    finally:
        del os.environ["MADQP_MAX_UPDATE_ENTRIES"]
