"""On-device sparse augmented-KKT path (solver/sparse_qp.py): supernodal
signed LDLᵀ of the quasi-definite K2 system, for LP and QP.

Oracles: exact KKT residual equations for the linear algebra; the dense
solver for end-to-end self-consistency (reference test/runtests.jl:95-135).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

import madqp_tpu as mq
from madqp_tpu.models.generators import banded_sparse_lp, random_qp
from madqp_tpu.ops import sparse_chol as SC
from madqp_tpu.solver.sparse_qp import (
    DeviceSparseAugmentedKKT,
    SparseQPProblem,
    solve_sparse_qp,
)


def _device_problem(kkt, n, m, H=None):
    if H is not None:
        Hcoo = sp.coo_matrix(H)
        h = (jnp.asarray(Hcoo.row.astype(np.int32)),
             jnp.asarray(Hcoo.col.astype(np.int32)),
             jnp.asarray(Hcoo.data))
    else:
        h = (jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32),
             jnp.zeros((0,)))
    return SparseQPProblem(
        c0=jnp.zeros(()), c=jnp.zeros(n), b=jnp.zeros(m),
        has_lb=jnp.ones(n, bool), has_ub=jnp.zeros(n, bool),
        a_rows=jnp.asarray(kkt.coo_rows),
        a_cols=jnp.asarray(kkt.coo_cols),
        a_vals=jnp.asarray(kkt.coo_vals),
        h_rows=h[0], h_cols=h[1], h_vals=h[2],
    )


def test_augmented_kkt_residual_qp():
    rng = np.random.default_rng(1)
    m, n = 35, 70
    A = sp.random(m, n, density=0.12, random_state=2, format="csr")
    A = A + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsr()
    B = sp.random(n, n, density=0.05, random_state=3)
    H = (B @ B.T).tocsc()  # PSD, full symmetric
    kkt = DeviceSparseAugmentedKKT(H, A)
    prob = _device_problem(kkt, n, m, H=kkt.H)

    pr_diag = jnp.asarray(rng.uniform(0.5, 2.0, n))
    del_c = -1e-6
    f = kkt.factorize(prob, pr_diag, del_c)
    assert bool(kkt.factor_ok(f))

    rx = jnp.asarray(rng.standard_normal(n))
    ry = jnp.asarray(rng.standard_normal(m))
    dx, dy = kkt.solve(f, rx, ry)

    Hd, Ad = H.toarray(), A.toarray()
    W = Hd + np.diag(np.asarray(pr_diag))
    r1 = W @ np.asarray(dx) + Ad.T @ np.asarray(dy) - np.asarray(rx)
    r2 = Ad @ np.asarray(dx) + del_c * np.asarray(dy) - np.asarray(ry)
    # Pivotless quasi-definite LDL trades a little backward error for
    # batched-front friendliness; 1e-7 on a unit-scale system is ample for the IPM
    # (the solve loop's check_residual tolerance is 1e-8 *relative*).
    assert np.abs(r1).max() < 1e-7
    assert np.abs(r2).max() < 1e-7


def test_inertia_check_rejects_indefinite():
    # A Hessian so indefinite the W block loses positivity: the pivot-sign
    # check must flag it (reference is_inertia_correct semantics).
    m, n = 10, 20
    A = sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsr()
    H = (-5.0 * sp.eye(n)).tocsc()
    kkt = DeviceSparseAugmentedKKT(H, A)
    prob = _device_problem(kkt, n, m, H=kkt.H)
    f = kkt.factorize(prob, jnp.full(n, 1e-8), -1e-8)
    assert not bool(kkt.factor_ok(f))


def test_sparse_qp_matches_dense_solver():
    qp = random_qp(n=60, m=30, seed=7)
    st = solve_sparse_qp(qp, tol=1e-8, print_level=0)
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status
    assert st.iter == ref.iter
    assert abs(st.objective - ref.objective) <= 1e-7 * max(1.0, abs(ref.objective))
    np.testing.assert_allclose(st.solution, ref.solution, atol=1e-6)


def test_sparse_qp_mixed_precision():
    # f32 factorization + f64 iterative refinement must still converge to
    # the f64 solution (reference mixed-precision hook,
    # src/linear_solver.jl:28-43).
    qp = random_qp(n=60, m=30, seed=7)
    st = solve_sparse_qp(qp, tol=1e-8, print_level=0,
                         factorization_dtype="float32", max_refine_steps=2)
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status
    assert abs(st.objective - ref.objective) <= 1e-6 * max(1.0, abs(ref.objective))


def test_sparse_augmented_lp_matches_dense_solver():
    qp = banded_sparse_lp(n=140, m=70, band=4, seed=9)
    st = solve_sparse_qp(qp, tol=1e-8, print_level=0)
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status
    assert st.iter == ref.iter
    assert abs(st.objective - ref.objective) <= 1e-7 * max(1.0, abs(ref.objective))


def test_sparse_kkt_via_mpcsolver():
    """Sparse device KKTs as first-class kkt_system options in the main
    driver: logging loop, warm starts, stats recovery all shared."""
    qp = banded_sparse_lp(n=120, m=60, band=4, seed=11)
    solver = mq.MPCSolver(qp, kkt_system="sparse-normal", tol=1e-8,
                          print_level=0)
    st = solver.solve()
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status == mq.Status.SOLVE_SUCCEEDED
    assert st.iter == ref.iter
    np.testing.assert_allclose(st.solution, ref.solution, atol=1e-6)

    # warm restart from the solution: should finish in O(1) iterations
    solver.set_initial_point(x=st.solution, y=st.multipliers,
                             zl=st.multipliers_L, zu=st.multipliers_U)
    st2 = solver.solve()
    assert st2.status == mq.Status.SOLVE_SUCCEEDED
    assert st2.iter <= 3

    qp2 = random_qp(n=40, m=20, seed=3)
    st3 = mq.MPCSolver(qp2, kkt_system="sparse-augmented", tol=1e-8,
                       print_level=0).solve()
    ref3 = mq.solve(qp2, tol=1e-8, print_level=0)
    assert st3.status == ref3.status
    assert abs(st3.objective - ref3.objective) <= 1e-7 * max(
        1.0, abs(ref3.objective))


def test_sparse_normal_rejects_qp_in_driver():
    qp = random_qp(n=20, m=10, seed=0)
    with pytest.raises(ValueError):
        mq.MPCSolver(qp, kkt_system="sparse-normal")


def test_sparse_qp_normal_diag_hessian():
    """Diagonal-Hessian QPs ride the normal-equations reduction (beyond
    the reference's LP-only NormalKKTSystem, normalkkt.jl:45-48): W = H + Σ
    stays diagonal, so S = A W⁻¹ Aᵀ is exact."""
    from madqp_tpu.models.generators import separable_qp

    qp = separable_qp(n=120, m=60, band=4, seed=2)
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    for kkt_system in ("normal", "auto"):
        st = solve_sparse_qp(qp, tol=1e-8, print_level=0,
                             kkt_system=kkt_system)
        assert st.status == ref.status
        assert abs(st.objective - ref.objective) <= 1e-7 * max(
            1.0, abs(ref.objective))
        np.testing.assert_allclose(st.solution, ref.solution, atol=1e-6)


def test_sparse_qp_auto_falls_back_to_augmented():
    """auto with a non-diagonal Hessian must still solve (augmented)."""
    qp = random_qp(n=40, m=20, seed=5)
    st = solve_sparse_qp(qp, tol=1e-8, print_level=0, kkt_system="auto")
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status
    assert abs(st.objective - ref.objective) <= 1e-7 * max(
        1.0, abs(ref.objective))


def test_sparse_qp_normal_rejects_nondiag_hessian():
    qp = random_qp(n=20, m=10, seed=0)
    with pytest.raises(ValueError, match="diagonal"):
        solve_sparse_qp(qp, tol=1e-8, print_level=0, kkt_system="normal")


def test_driver_sparse_normal_diag_hessian():
    """MPCSolver(kkt_system='sparse-normal') accepts diagonal-H QPs."""
    from madqp_tpu.models.suite import svm_qp

    qp = svm_qp(50, 8, seed=4)
    st = mq.MPCSolver(qp, kkt_system="sparse-normal", tol=1e-8,
                      print_level=0).solve()
    ref = mq.solve(qp, tol=1e-8, print_level=0)
    assert st.status == ref.status
    assert abs(st.objective - ref.objective) <= 1e-6 * max(
        1.0, abs(ref.objective))
