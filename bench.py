"""Benchmark entry point — prints ONE JSON line.

Protocol: BASELINE config #1 ("single dense convex QP, random SPD H,
box + equality constraints, n=500, Mehrotra predictor-corrector").
Metric: interior-point iterations per second on the end-to-end jitted solve
(compile excluded; the per-iteration cost is dominated by the KKT
factorization, matching the reference's linear_solver_time share).
"""

import json
import time

import numpy as np


def main():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's backend is "
            f"{jax.default_backend()!r}")
    import madqp_tpu as mq
    from madqp_tpu.models.qp import build_standard_form
    from madqp_tpu.solver import state as S
    from madqp_tpu.solver.mpc import MPCKernel
    from madqp_tpu.utils.options import IPMOptions

    n, m = 500, 200
    qp = mq.random_qp(n, m, seed=0, ineq=True)
    # Headline config: f32 Jacobi-scaled factorization + one f64 refinement
    # step — converges to tol=1e-8 with iteration counts identical to full
    # f64.
    opts = IPMOptions(
        print_level=40,
        tol=1e-8,
        max_ncorr=0,
        step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8),
        factorization_dtype="float32",
        max_refine_steps=1,
    )
    std, info, x0, y0 = build_standard_form(qp)
    import jax.numpy as jnp

    dtype = jnp.dtype(opts.dtype)
    prob, lb, ub = S.problem_to_device(std, dtype)
    x0 = jnp.asarray(x0, dtype)
    y0 = jnp.asarray(y0, dtype)

    kernel = MPCKernel(opts)
    solve = jax.jit(kernel.solve_from)

    # Warm-up (compile).
    t0 = time.time()
    final = jax.block_until_ready(solve(prob, x0, y0, lb, ub))
    compile_and_first = time.time() - t0
    iters = int(final.k)
    assert int(final.status) == S.SUCCESS, f"bench solve failed: {int(final.status)}"

    walls = []
    for _ in range(3):
        t0 = time.time()
        final = jax.block_until_ready(solve(prob, x0, y0, lb, ub))
        walls.append(time.time() - t0)
        assert int(final.status) == S.SUCCESS
    wall = float(np.median(walls))

    iters_per_s = iters / wall
    result = {
        "metric": "qp_n500_mpc_iters_per_s",
        "value": iters_per_s,
        "unit": "iters/s",
        "vs_baseline": None,
        "detail": {
            "n": n,
            "m": m,
            "iters": iters,
            "solve_s": wall,
            "compile_plus_first_s": compile_and_first,
            "objective": float(final.obj_val),
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "dtype": str(dtype),
            "factorization_dtype": opts.factorization_dtype or str(dtype),
        },
    }
    # Secondary metric (best-effort, never breaks the headline): batched
    # lockstep throughput (BASELINE config #4).
    try:
        result["detail"]["batched"] = _batched_throughput(mq)
    except Exception as e:  # pragma: no cover - defensive
        result["detail"]["batched_error"] = repr(e)
    # Roofline accounting: live f32 Cholesky at n=2048 against the card's
    # published peaks (utils/roofline.py).
    try:
        result["detail"]["roofline"] = _roofline(jax)
    except Exception as e:  # pragma: no cover - defensive
        result["detail"]["roofline_error"] = repr(e)
    # Sparse device-path headline: grid-20k LP cold (symbolic + compiles +
    # solve) and warm re-solve of the same data.
    try:
        result["detail"]["sparse_grid20k"] = _sparse_headline(mq)
    except Exception as e:  # pragma: no cover - defensive
        result["detail"]["sparse_error"] = repr(e)
    print(json.dumps(result))


def _sparse_headline(mq):
    from madqp_tpu.models.generators import grid_lp

    qp = grid_lp(g=100, seed=0)
    kw = dict(print_level=40, factorization_dtype="float32",
              max_refine_steps=1, tol=1e-8,
              step_rule=mq.AdaptiveStep(0.995),
              regularization=mq.FixedRegularization(1e-8, -1e-8))
    t0 = time.time()
    st = mq.solve_sparse_lp(qp, **kw)
    cold = time.time() - t0
    t0 = time.time()
    st2 = mq.solve_sparse_lp(qp, **kw)
    warm = time.time() - t0
    assert st.status == 1 and st2.status == 1
    return {
        "case": "grid_lp g=100 (n=20000, m=10000)",
        "cold_total_s": cold,
        "warm_total_s": warm,
        "iters": int(st2.iter),
        "warm_per_iter_s": warm / max(1, int(st2.iter)),
    }


def _roofline(jax, n=2048):
    import jax.numpy as jnp

    from madqp_tpu.utils.roofline import (dense_ldl_bytes, dense_ldl_flops,
                                          roofline_report)

    rng = np.random.default_rng(0)
    # Pin f32: under x64, `f32 / np.sqrt(n)` (np.float64 scalar) would
    # promote to f64.
    P = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    F = jnp.asarray(P @ P.T + 2.0 * np.eye(n, dtype=np.float32),
                    jnp.float32)

    @jax.jit
    def chol(M):
        with jax.default_matmul_precision("highest"):
            return jnp.linalg.cholesky(M)

    jax.block_until_ready(chol(F))  # compile
    best = float("inf")
    for _ in range(5):
        t0 = time.time()
        jax.block_until_ready(chol(F))
        best = min(best, time.time() - t0)
    rep = roofline_report(dense_ldl_flops(n), dense_ldl_bytes(n, 4), best)
    return {"live_chol_n2048": rep}


def _batched_throughput(mq, batch=512, n=32, m=16):
    """Instances/s for a vmapped lockstep solve of `batch` small QPs
    (per-instance convergence masking; benchmarks/bench_batched.py)."""
    from madqp_tpu.parallel import BatchedMPCSolver

    qps = [mq.dense_dummy_qp(n, m, seed=i) for i in range(batch)]
    solver = BatchedMPCSolver.from_problems(
        qps, tol=1e-8, print_level=40,
        step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8),
        factorization_dtype="float32", max_refine_steps=1)
    t0 = time.time()
    solver.solve_batch()  # warm-up (compile)
    compile_and_first = time.time() - t0
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        final = solver.solve_batch()
    wall = (time.time() - t0) / reps
    ok = sum(int(s) == 1 for s in final.status[: solver.n_real])
    return {
        "metric": f"qp_batched{batch}_instances_per_s",
        "value": batch / wall,
        "unit": "instances/s",
        "batch": batch, "n": n, "m": m, "solved": ok,
        "wall_s": wall,
        "compile_plus_first_s": compile_and_first,
    }


if __name__ == "__main__":
    main()
