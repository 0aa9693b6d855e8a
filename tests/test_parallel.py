"""Batched/sharded solver tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

import madqp_tpu as mq
from madqp_tpu import Status
from madqp_tpu.parallel import BatchedMPCSolver, solve_batched


def _problems(k=4):
    return [mq.dense_dummy_qp(8 + i, 4, seed=i) for i in range(k)]


class TestBatched:
    def test_batched_matches_single(self):
        qps = _problems(4)
        batched = solve_batched(qps, print_level=40)
        for qp, bstat in zip(qps, batched):
            single = mq.solve(qp, print_level=40)
            assert bstat.status == Status.SOLVE_SUCCEEDED
            assert bstat.objective == pytest.approx(single.objective, abs=1e-5)
            np.testing.assert_allclose(bstat.solution, single.solution, atol=1e-4)

    def test_heterogeneous_shapes_padding(self):
        """Different (n, m) instances pad to a common shape and still solve."""
        qps = [
            mq.dense_dummy_qp(6, 2, seed=1),
            mq.dense_dummy_qp(12, 7, seed=2),
            mq.simple_lp(),
        ]
        stats = solve_batched(qps, print_level=40)
        assert all(s.status == Status.SOLVE_SUCCEEDED for s in stats)
        assert stats[2].objective == pytest.approx(1.0, abs=1e-6)

    def test_sharded_over_mesh(self):
        """Shard the batch over all 8 virtual devices."""
        n_dev = len(jax.devices())
        assert n_dev == 8, "conftest must provide 8 virtual CPU devices"
        mesh = jax.make_mesh((n_dev,), ("batch",))
        qps = [mq.dense_dummy_qp(10, 5, seed=i) for i in range(2 * n_dev)]
        solver = BatchedMPCSolver.from_problems(
            qps, mesh=mesh, print_level=40
        )
        stats = solver.solve_all()
        assert len(stats) == 2 * n_dev
        assert all(s.status == Status.SOLVE_SUCCEEDED for s in stats)
        # cross-check one against the single-instance path
        single = mq.solve(qps[3], print_level=40)
        assert stats[3].objective == pytest.approx(single.objective, abs=1e-5)

    def test_batch_not_multiple_of_mesh(self):
        """Batch size is rounded up to the mesh size internally."""
        mesh = jax.make_mesh((4,), ("batch",))
        qps = _problems(3)  # 3 -> padded to 4
        solver = BatchedMPCSolver.from_problems(qps, mesh=mesh, print_level=40)
        stats = solver.solve_all()
        assert len(stats) == 3
        assert all(s.status == Status.SOLVE_SUCCEEDED for s in stats)


def test_graft_entry_single():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert int(out.k) == 1


def test_graft_entry_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_batched_mixed_precision_rescue():
    """An ill-conditioned lane that stalls in f32 must not burn max_iter
    for the whole batch: the f64 warm rescue phase finishes it."""
    import madqp_tpu as mq
    from madqp_tpu.models import suite as S
    from madqp_tpu.parallel import solve_batched

    qps = [S.transport_lp(12, 15, seed=0), mq.dense_dummy_qp(30, 12, seed=1)]
    qps = [mq.scale_qp(mq.presolve_qp(q)[0])[0] for q in qps]
    stats = solve_batched(qps, tol=1e-8, max_iter=300, print_level=40,
                          factorization_dtype="float32", max_refine_steps=1)
    assert all(s.status == mq.Status.SOLVE_SUCCEEDED for s in stats)
    assert all(s.iter < 100 for s in stats)


def test_batched_stepped_loop_matches_jit():
    """loop_mode='python' (chunked host-stepped dispatch, the large-dim
    default under 'auto') must reproduce the single-program while_loop
    solve bit-for-bit in status/iterations/objective — it bounds the
    work of each dispatch on long lockstep solves."""
    qps = _problems(5)
    ref = BatchedMPCSolver.from_problems(
        qps, print_level=40, tol=1e-8, loop_mode="jit")
    stepped = BatchedMPCSolver.from_problems(
        qps, print_level=40, tol=1e-8, loop_mode="python")
    for a, b in zip(ref.solve_all(), stepped.solve_all()):
        assert b.status == Status.SOLVE_SUCCEEDED
        assert b.iter == a.iter
        assert b.objective == pytest.approx(a.objective, rel=1e-12, abs=1e-12)

    # two-phase rescue with a stepped f64 endgame
    rescue = BatchedMPCSolver.from_problems(
        qps, print_level=40, tol=1e-8, loop_mode="python",
        factorization_dtype="float32", max_refine_steps=1)
    for a, b in zip(ref.solve_all(), rescue.solve_all()):
        assert b.status == Status.SOLVE_SUCCEEDED
        assert b.objective == pytest.approx(a.objective, rel=1e-6, abs=1e-6)


def test_batched_lane_shrunk_rescue_matches_full_width():
    """When only a few lanes fail phase 1, the rescue gathers exactly
    those lanes (padded to a pow2 count), runs the warm f64 phase on the
    small batch, and scatters back — results must match the full-width
    lockstep rescue (which it replaces for cost: rescuing 2 of 10 lanes
    runs a fifth of the f64 lanes)."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import structured_suite
    from madqp_tpu.parallel import BatchedMPCSolver

    qps = [qp for _, qp in structured_suite(
        "medium", seeds=(0,),
        families=("illscaled", "svm", "redundant", "ranges"))]
    kw = dict(tol=1e-8, max_ncorr=0, factorization_dtype="float32",
              max_refine_steps=1, step_rule=mq.AdaptiveStep(0.995),
              regularization=mq.FixedRegularization(1e-8, -1e-8),
              endgame="f64")  # pin the pure-device (lane-shrunk) rescue
    stats = BatchedMPCSolver.from_problems(qps, **kw).solve_all()
    # Full-width rescue reference values (recorded pre-change).  The
    # illscaled lane — the one that actually triggers the rescue — has no
    # stable objective to pin: its pathological scaling makes the scaled
    # 1e-8 stopping point depend on reduction order (serial f64 103.02,
    # f32+IR 99.32, host native 103.59, HiGHS 86.50), so for it we assert
    # success only; the well-scaled lanes must be untouched by the
    # scatter-back.
    expect = {"svm_80x15_0": 1.203104e+01,
              "redundant_80_0": 5.393131e+01, "ranges_100_0": -1.152612e+01}
    for q, st in zip(qps, stats):
        assert st.status == mq.Status.SOLVE_SUCCEEDED, (q.name, st.status)
        if q.name in expect:
            assert st.objective == pytest.approx(expect[q.name], rel=1e-4)


def test_batched_host_rescue_default():
    """endgame='auto' (default): lanes that fail the f32 phase re-solve on
    the host C++ LDL path — every instance must come back SOLVE_SUCCEEDED
    with the host's f64 objective, and untouched lanes keep their device
    results."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import structured_suite
    from madqp_tpu.native import available
    from madqp_tpu.parallel import BatchedMPCSolver

    if not available():
        pytest.skip("native library unavailable")
    qps = [qp for _, qp in structured_suite(
        "medium", seeds=(0,),
        families=("illscaled", "svm", "redundant", "ranges"))]
    solver = BatchedMPCSolver.from_problems(
        qps, tol=1e-8, max_ncorr=0, factorization_dtype="float32",
        max_refine_steps=1, step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8))
    stats = solver.solve_all()
    rescued = getattr(solver, "_rescue_overrides", {})
    assert rescued, "expected at least one host-rescued lane"
    host_ref = {i: mq.solve_host(
        qps[i], tol=1e-8, print_level=30, max_ncorr=0,
        step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8))
        for i in rescued}
    for i, (q, st) in enumerate(zip(qps, stats)):
        assert st.status == mq.Status.SOLVE_SUCCEEDED, (q.name, st.status)
        if i in rescued:
            assert st.objective == pytest.approx(
                host_ref[i].objective, rel=1e-8)
