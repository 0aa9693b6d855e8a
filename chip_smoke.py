"""GPU smoke check: every user entry point of madqp_tpu, once, at a real
size, against references that do not call the solver under test.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: the sharded batched and
                                         # sharded two-stage paths only

Phases (one card): dense, sparse_lp, sparse_qp, batched, two_stage,
qp_layer, kernels.  Each configuration prints one JSON line with its sizes,
status, iterations, cold_s (first solve, compile included), warm_s (second
solve of value-perturbed data of the same pattern, unless the line says
otherwise) and each error beside its tolerance.

References:
  R1  NumPy f64 KKT check of the returned primal-dual point on the original
      problem: relative primal residual, dual residual and complementarity,
      each <= 1e-7 (the solver's tol is 1e-8; the GPU sums in another
      order).
  R2  |obj - obj_ref| <= 1e-6 max(1, |obj_ref|), obj_ref from HiGHS
      (scipy.optimize.linprog) for LPs and from the host C++ LDL path
      (mq.solve_host) for QPs.

The script exits non-zero, and prints no result line, when JAX's backend is
not a GPU or any check fails.  Its last line on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

R1_TOL = 1e-7
R2_TOL = 1e-6
FD_RTOL = 1e-4

# Problem sizes of each phase.
SIZES = dict(
    dense_n=4096, dense_m=2048,
    dense_ref_n=2048, dense_ref_m=1024,   # R2 size (solve_host is O(n^3))
    grid_g=100,                           # grid_lp: n=2 g^2, m=g^2
    chain_n=50000,                        # chainqp xlarge (models/suite.py)
    batch=1024, batch_n=64, batch_m=32, batch_ref_lanes=8,
    ts_n0=50, ts_ns=200, ts_ms=100, ts_m0=20, ts_N=64,
    ts_ref_N=8,                           # R2 size (host path on the flat QP)
    layer_batch=256, layer_n=64, layer_m=16,
    chol_n=4096, chol_sweep=(128, 256, 512, 1024),
    four_batch=4096, four_ts_N=256,
)


class CheckFailed(AssertionError):
    pass


def emit(rec: dict):
    print(json.dumps(rec), flush=True)


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def _perturbed(qp, rel=1e-3):
    """Same pattern, other values: the warm solve's data."""
    import dataclasses

    return dataclasses.replace(qp, c=qp.c * (1.0 + rel))


# ---------------------------------------------------------------------------
# R1: KKT residuals of a returned point on the ORIGINAL problem (NumPy f64)
# ---------------------------------------------------------------------------


def kkt_residuals(qp, st) -> dict:
    """Relative primal residual, dual residual and complementarity of the
    point (solution, multipliers, multipliers_L, multipliers_U) for

        min c'x + x'Hx/2  s.t.  lcon <= Ax <= ucon,  lvar <= x <= uvar

    in the solver's sign convention: Hx + c + A'y - zl + zu = 0, with
    y > 0 where Ax sits at ucon and y < 0 where it sits at lcon."""
    x = np.asarray(st.solution, np.float64)
    y = np.asarray(st.multipliers, np.float64)
    zl = np.asarray(st.multipliers_L, np.float64)
    zu = np.asarray(st.multipliers_U, np.float64)
    A = qp.A
    Ax = np.asarray(A @ x).ravel()
    g = qp.c.copy()
    if qp.H is not None:
        g = g + np.asarray(qp.H @ x).ravel()

    def fin(v):
        return v[np.isfinite(v)]

    scale_b = max(1.0, *(np.abs(fin(v)).max(initial=0.0)
                         for v in (qp.lcon, qp.ucon, qp.lvar, qp.uvar)))
    viol = np.concatenate([
        np.maximum(qp.lcon - Ax, 0.0), np.maximum(Ax - qp.ucon, 0.0),
        np.maximum(qp.lvar - x, 0.0), np.maximum(x - qp.uvar, 0.0)])
    primal = float(np.max(viol, initial=0.0)) / scale_b

    scale_c = max(1.0, float(np.max(np.abs(qp.c), initial=0.0)))
    r = g + np.asarray(A.T @ y).ravel() - zl + zu
    # Multipliers of absent bounds must vanish, present ones be >= 0.
    sign = np.concatenate([
        np.minimum(zl, 0.0), np.minimum(zu, 0.0),
        np.where(np.isfinite(qp.lvar), 0.0, zl),
        np.where(np.isfinite(qp.uvar), 0.0, zu),
        np.where(np.isfinite(qp.ucon), 0.0, np.maximum(y, 0.0)),
        np.where(np.isfinite(qp.lcon), 0.0, np.minimum(y, 0.0))])
    dual = max(float(np.max(np.abs(r), initial=0.0)),
               float(np.max(np.abs(sign), initial=0.0))) / scale_c

    def slack(v, bound, sgn):
        """sgn * (v - bound) where the bound is finite, else 0."""
        ok = np.isfinite(bound)
        return np.where(ok, sgn * (v - np.where(ok, bound, 0.0)), 0.0)

    ineq = qp.lcon != qp.ucon
    prods = np.concatenate([
        zl * slack(x, qp.lvar, 1.0), zu * slack(x, qp.uvar, -1.0),
        np.where(ineq, np.maximum(-y, 0.0) * slack(Ax, qp.lcon, 1.0), 0.0),
        np.where(ineq, np.maximum(y, 0.0) * slack(Ax, qp.ucon, -1.0), 0.0)])
    compl = float(np.max(np.abs(prods), initial=0.0)) / scale_c
    return {"primal": primal, "dual": dual, "compl": compl}


def check_r1(qp, st) -> dict:
    res = kkt_residuals(qp, st)
    bad = {k: v for k, v in res.items() if not v <= R1_TOL}
    if bad:
        raise CheckFailed(f"R1 over {R1_TOL}: {bad}")
    return {"r1": res, "r1_tol": R1_TOL}


def check_r2(obj, obj_ref) -> dict:
    err = abs(obj - obj_ref)
    tol = R2_TOL * max(1.0, abs(obj_ref))
    if not err <= tol:
        raise CheckFailed(f"R2: |{obj} - {obj_ref}| = {err} > {tol}")
    return {"obj": obj, "obj_ref": obj_ref, "r2_err": err, "r2_tol": tol}


def check_success(st, what=""):
    import madqp_tpu as mq

    if st.status != mq.Status.SOLVE_SUCCEEDED:
        raise CheckFailed(f"{what} status {st.status!r}")


def highs_objective(qp) -> float:
    """LP optimum from HiGHS (scipy.optimize.linprog)."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    assert qp.H is None
    A = sp.csr_matrix(qp.A)
    eq = qp.lcon == qp.ucon
    up = ~eq & np.isfinite(qp.ucon)
    lo = ~eq & np.isfinite(qp.lcon)
    A_ub = sp.vstack([A[up], -A[lo]]).tocsr()
    b_ub = np.concatenate([qp.ucon[up], -qp.lcon[lo]])
    bounds = np.column_stack([
        np.where(np.isfinite(qp.lvar), qp.lvar, -np.inf),
        np.where(np.isfinite(qp.uvar), qp.uvar, np.inf)])
    bounds = [(None if not np.isfinite(lb) else lb,
               None if not np.isfinite(ub) else ub) for lb, ub in bounds]
    res = linprog(qp.c, A_ub=A_ub if A_ub.shape[0] else None,
                  b_ub=b_ub if A_ub.shape[0] else None,
                  A_eq=A[eq] if eq.any() else None,
                  b_eq=qp.lcon[eq] if eq.any() else None,
                  bounds=bounds, method="highs")
    if res.status != 0:
        raise CheckFailed(f"HiGHS reference failed: {res.message}")
    return float(res.fun) + qp.c0


def host_objective(qp, **kw) -> float:
    import madqp_tpu as mq

    ref = mq.solve_host(qp, print_level=40, **kw)
    check_success(ref, "solve_host reference")
    return float(ref.objective)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

MIXED = dict(factorization_dtype="float32", max_refine_steps=1)


def phase_dense(S):
    """mq.solve on a dense QP in three configurations."""
    import madqp_tpu as mq

    qp = mq.random_qp(S["dense_n"], S["dense_m"], seed=0, ineq=True)
    qp_w = _perturbed(qp)
    qp_ref = mq.random_qp(S["dense_ref_n"], S["dense_ref_m"], seed=0,
                          ineq=True)
    obj_ref, ref_s = _timed(host_objective, qp_ref)
    configs = {"f64": {}, "mixed": MIXED, "blocked": dict(
        linear_solver="blocked")}
    for name, kw in configs.items():
        kw = dict(print_level=40, tol=1e-8, **kw)
        st, cold = _timed(mq.solve, qp, **kw)
        check_success(st, f"dense/{name}")
        st_w, warm = _timed(mq.solve, qp_w, **kw)
        check_success(st_w, f"dense/{name} warm")
        st_r = mq.solve(qp_ref, **kw)
        check_success(st_r, f"dense/{name} at the R2 size")
        rec = dict(phase="dense", config=name, n=S["dense_n"],
                   m=S["dense_m"], status=int(st.status), iters=st.iter,
                   cold_s=cold, warm_s=warm, **check_r1(qp, st),
                   r2_n=S["dense_ref_n"], r2_m=S["dense_ref_m"],
                   r2_ref_s=ref_s, r2_r1=check_r1(qp_ref, st_r)["r1"],
                   **check_r2(float(st_r.objective), obj_ref))
        emit(rec)


def phase_sparse_lp(S):
    """mq.solve_sparse_lp on grid_lp: dense-normal (auto) and supernodal
    (batched) routes, host and device endgames, chunked and jit loops."""
    import madqp_tpu as mq

    qp = mq.grid_lp(g=S["grid_g"], seed=0)
    qp_w = _perturbed(qp)
    obj_ref, ref_s = _timed(highs_objective, qp)
    n, m = qp.nvar, qp.ncon
    for mode in ("auto", "batched"):
        for endgame, loop in (("auto", "auto"), ("f64", "auto"),
                              ("f64", "jit")):
            kw = dict(print_level=40, tol=1e-8, mode=mode, endgame=endgame,
                      loop_mode=loop, **MIXED)
            st, cold = _timed(mq.solve_sparse_lp, qp, **kw)
            check_success(st, f"sparse_lp/{mode}/{endgame}/{loop}")
            st_w, warm = _timed(mq.solve_sparse_lp, qp_w, **kw)
            check_success(st_w, f"sparse_lp/{mode}/{endgame}/{loop} warm")
            backend = st.counters.endgame_backend
            if endgame == "f64" and not backend.startswith("device"):
                raise CheckFailed(
                    f"sparse_lp/{mode}: asked for the device endgame, "
                    f"ran {backend!r}")
            emit(dict(phase="sparse_lp", mode=mode, endgame=endgame,
                      loop_mode=loop, endgame_backend=backend, n=n, m=m,
                      status=int(st.status), iters=st.iter, cold_s=cold,
                      warm_s=warm, ref_s=ref_s, **check_r1(qp, st),
                      **check_r2(float(st.objective), obj_ref)))
    # Determinism: the supernodal f64 route twice on the same data.
    kw = dict(print_level=40, tol=1e-8, mode="batched", endgame="f64",
              **MIXED)
    a = mq.solve_sparse_lp(qp, **kw)
    b = mq.solve_sparse_lp(qp, **kw)
    emit(dict(phase="sparse_lp", check="repeat", mode="batched",
              endgame="f64", bit_identical=bool(
                  np.array_equal(a.solution, b.solution)
                  and np.array_equal(a.multipliers, b.multipliers)),
              iters=[a.iter, b.iter],
              max_abs_diff=float(np.max(np.abs(a.solution - b.solution)))))


def phase_sparse_qp(S):
    """mq.solve_sparse_qp on chainqp (xlarge): two-phase and pure f64."""
    import madqp_tpu as mq
    from madqp_tpu.models.suite import chain_qp

    qp = chain_qp(S["chain_n"], seed=0)
    qp_w = _perturbed(qp)
    obj_ref, ref_s = _timed(host_objective, qp)
    for name, kw in (("two-phase", MIXED), ("f64", dict(
            factorization_dtype=""))):
        kw = dict(print_level=40, tol=1e-8, **kw)
        st, cold = _timed(mq.solve_sparse_qp, qp, **kw)
        check_success(st, f"sparse_qp/{name}")
        st_w, warm = _timed(mq.solve_sparse_qp, qp_w, **kw)
        check_success(st_w, f"sparse_qp/{name} warm")
        backend = st.counters.endgame_backend
        if backend == "host-full":
            raise CheckFailed(f"sparse_qp/{name} rerouted to the host")
        emit(dict(phase="sparse_qp", config=name, endgame_backend=backend,
                  n=qp.nvar, m=qp.ncon, status=int(st.status),
                  iters=st.iter, cold_s=cold, warm_s=warm, ref_s=ref_s,
                  **check_r1(qp, st),
                  **check_r2(float(st.objective), obj_ref)))


def _batch_qps(count, n, m):
    import madqp_tpu as mq

    return [mq.dense_dummy_qp(n, m, seed=i) for i in range(count)]


BATCH_OPTS = dict(tol=1e-8, print_level=40, **MIXED)


def phase_batched(S):
    """BatchedMPCSolver over dense_dummy_qp lanes (BASELINE config #4)."""
    from madqp_tpu.parallel import BatchedMPCSolver

    B, n, m = S["batch"], S["batch_n"], S["batch_m"]
    qps = _batch_qps(B, n, m)

    solver, setup = _timed(BatchedMPCSolver.from_problems, qps,
                           **BATCH_OPTS)
    stats, cold = _timed(solver.solve_all)
    rescued = len(getattr(solver, "_rescue_overrides", {}))
    stats_w, warm = _timed(solver.solve_all)
    bad = [i for i, s in enumerate(stats) if not s.success]
    bad_w = [i for i, s in enumerate(stats_w) if not s.success]
    if bad or bad_w:
        raise CheckFailed(f"batched: lanes not solved {bad[:8]} {bad_w[:8]}")
    lanes = np.linspace(0, B - 1, S["batch_ref_lanes"]).astype(int)
    r1 = {}
    r2 = {}
    for i in lanes:
        r1[int(i)] = check_r1(qps[i], stats[i])["r1"]
        r2[int(i)] = check_r2(float(stats[i].objective),
                              host_objective(qps[i]))["r2_err"]
    emit(dict(phase="batched", lanes=B, n=n, m=m,
              status=int(stats[0].status),
              iters=int(max(s.iter for s in stats)),
              setup_s=setup, cold_s=cold, warm_s=warm, warm_data="same",
              host_rescued=rescued,
              ref_lanes=[int(i) for i in lanes], r1=r1, r1_tol=R1_TOL,
              r2_err=r2, r2_tol_rel=R2_TOL))


def _two_stage(S, N, seed=0):
    from madqp_tpu.parallel.structured import random_two_stage

    return random_two_stage(n0=S["ts_n0"], ns=S["ts_ns"], ms=S["ts_ms"],
                            m0=S["ts_m0"], N=N, seed=seed)


def phase_two_stage(S):
    """solve_two_stage (Schur decomposition, no mesh)."""
    import madqp_tpu as mq
    from madqp_tpu.parallel.structured import (solve_two_stage,
                                               two_stage_to_flat_qp)

    prob, lb, ub = _two_stage(S, S["ts_N"])
    kw = dict(print_level=40, tol=1e-8)
    st, cold = _timed(solve_two_stage, prob, lb, ub, **kw)
    check_success(st, "two_stage")
    prob_w = prob._replace(c=prob.c * (1.0 + 1e-3))
    st_w, warm = _timed(solve_two_stage, prob_w, lb, ub, **kw)
    check_success(st_w, "two_stage warm")
    flat = two_stage_to_flat_qp(prob, lb, ub)
    r1 = check_r1(flat, st)
    # R2 at a smaller scenario count: the host LDL of the flat QP fills in
    # through the first-stage columns and its time grows about as N^3.
    # The host K2 LDL is pivot-free, so it needs the
    # quasi-definite regularization (the reference's benchmark setting).
    prob_r, lb_r, ub_r = _two_stage(S, S["ts_ref_N"])
    st_r = solve_two_stage(prob_r, lb_r, ub_r, **kw)
    check_success(st_r, "two_stage at the R2 size")
    obj_ref, ref_s = _timed(
        host_objective, two_stage_to_flat_qp(prob_r, lb_r, ub_r),
        regularization=mq.FixedRegularization(1e-8, -1e-8))
    emit(dict(phase="two_stage", N=S["ts_N"], n=prob.n, m=prob.m,
              status=int(st.status), iters=st.iter, cold_s=cold,
              warm_s=warm, **r1, r2_N=S["ts_ref_N"], ref_s=ref_s,
              **check_r2(float(st_r.objective), obj_ref)))


def _layer_data(S, seed=0):
    rng = np.random.default_rng(seed)
    B, n, m = S["layer_batch"], S["layer_n"], S["layer_m"]
    P = rng.standard_normal((B, n, n)) / np.sqrt(n)
    H = np.einsum("bki,bkj->bij", P, P) + 0.3 * np.eye(n)
    c = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    b = np.einsum("bij,bj->bi", A, rng.uniform(0.25, 0.75, (B, n)))
    lb = np.zeros((B, n))
    ub = np.ones((B, n))
    w = rng.standard_normal(n)
    return H, c, A, b, lb, ub, w


def phase_qp_layer(S):
    """vmap(mq.qp_layer) forward + grad, gradient vs central differences
    through solve_host."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import madqp_tpu as mq

    H, c, A, b, lb, ub, w = _layer_data(S)
    wj = jnp.asarray(w)

    def loss(c_):
        sol = jax.vmap(lambda H_, c1, A_, b_, l_, u_: mq.qp_layer(
            H_, c1, A_, b_, l_, u_, tol=1e-10))(H, c_, A, b, lb, ub)
        return jnp.sum(sol.x @ wj), sol

    fwd_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    ((val, sol), g), cold = _timed(
        lambda c_: jax.block_until_ready(fwd_grad(c_)), jnp.asarray(c))
    ((_, sol_w), _), warm = _timed(
        lambda c_: jax.block_until_ready(fwd_grad(c_)),
        jnp.asarray(c * (1.0 + 1e-3)))
    status = np.asarray(sol.status)
    if not (np.all(status == 1) and np.all(np.asarray(sol_w.status) == 1)):
        raise CheckFailed(f"qp_layer: lanes not solved "
                          f"{np.flatnonzero(status != 1)[:8]}")
    g = np.asarray(g)

    def host_loss(i, ci):
        qp = mq.QuadraticProblem(
            c=ci, H=sp.csr_matrix(H[i]), A=sp.csr_matrix(A[i]),
            lcon=b[i], ucon=b[i], lvar=lb[i], uvar=ub[i])
        st = mq.solve_host(qp, print_level=40, tol=1e-10)
        check_success(st, "qp_layer host reference")
        return float(st.solution @ w)

    h = 1e-3
    # Three fixed problems; in each, the entry with the largest gradient
    # (entries of variables held at a bound have zero gradient, where a
    # relative comparison means nothing).
    rows = (0, S["layer_batch"] // 2, S["layer_batch"] - 1)
    fd = {}
    for i in rows:
        j = int(np.argmax(np.abs(g[i])))
        e = np.zeros(S["layer_n"])
        e[j] = h
        d = (host_loss(i, c[i] + e) - host_loss(i, c[i] - e)) / (2 * h)
        err = abs(g[i, j] - d) / max(abs(d), 1e-12)
        fd[f"{i},{j}"] = {"grad": float(g[i, j]), "fd": d, "rel_err": err}
        if not err <= FD_RTOL:
            raise CheckFailed(f"qp_layer grad[{i},{j}] {g[i, j]} vs FD {d}")
    emit(dict(phase="qp_layer", batch=S["layer_batch"], n=S["layer_n"],
              m=S["layer_m"], status=1, iters=int(np.max(sol.iters)),
              cold_s=cold, warm_s=warm, loss=float(val), fd=fd,
              fd_rtol=FD_RTOL))


def _bench(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernels(S):
    """The factorizations the paths run, against NumPy f64."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import madqp_tpu as mq
    from madqp_tpu.ops import sparse_chol as SC
    from madqp_tpu.ops.blocked_dense import factor_inv_chol

    n = S["chol_n"]
    rng = np.random.default_rng(0)
    P = rng.standard_normal((n, n)) / np.sqrt(n)
    M = P @ P.T + 2.0 * np.eye(n)
    nrm = np.linalg.norm(M)
    chol = jax.jit(jnp.linalg.cholesky)

    def recon(L):
        L = np.asarray(L, np.float64)
        return float(np.linalg.norm(L @ L.T - M) / nrm)

    L64 = chol(jnp.asarray(M))
    e64 = recon(L64)
    with jax.default_matmul_precision("highest"):
        chol32 = jax.jit(jnp.linalg.cholesky)
        L32 = chol32(jnp.asarray(M, jnp.float32))
    e32 = recon(L32)
    fic = jax.jit(factor_inv_chol)
    Lc, iL = fic(jnp.asarray(M))
    efic = recon(Lc)
    einv = float(np.linalg.norm(np.asarray(iL) @ np.asarray(Lc) - np.eye(n))
                 / np.sqrt(n))
    # TF32 probe: one f32 product at default precision and at "highest".
    X = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    mm = jax.jit(lambda a, b: a @ b)
    mm_hi = jax.jit(lambda a, b: jnp.matmul(a, b, precision="highest"))
    ref = np.asarray(X, np.float64) @ np.asarray(X, np.float64)
    rnorm = np.linalg.norm(ref)
    d_def = float(np.linalg.norm(np.asarray(mm(X, X), np.float64) - ref)
                  / rnorm)
    d_hi = float(np.linalg.norm(np.asarray(mm_hi(X, X), np.float64) - ref)
                 / rnorm)
    # Supernodal factor + solve of the grid_lp normal matrix.
    qp = mq.grid_lp(g=S["grid_g"], seed=0)
    A = sp.csr_matrix(qp.A)
    Snorm = (A @ A.T + 1e-2 * sp.eye(A.shape[0])).tocsc()
    bs, t_sym = _timed(SC.analyze_batched, Snorm)
    vals = jnp.asarray(bs.permute_values(Snorm))
    bs_dev = jax.device_put(bs)
    fact = jax.jit(SC.factorize_batched)
    solv = jax.jit(SC.solve_batched)
    bvec = rng.standard_normal(A.shape[0])
    x = np.asarray(solv(bs_dev, fact(bs_dev, vals), jnp.asarray(bvec)))
    esn = float(np.linalg.norm(Snorm @ x - bvec) / np.linalg.norm(bvec))
    t_sn = _bench(lambda v: solv(bs_dev, fact(bs_dev, v), jnp.asarray(bvec)),
                  vals)
    rec = dict(phase="kernels", n=n,
               chol_f64_recon=e64, chol_f64_tol=1e-13,
               chol_f32_highest_recon=e32, chol_f32_tol=1e-5,
               factor_inv_chol_recon=efic, factor_inv_chol_inv_err=einv,
               factor_inv_chol_tol=1e-12,
               matmul_f32_default_rel_err=d_def,
               matmul_f32_highest_rel_err=d_hi,
               tf32_in_play=bool(d_def > 10 * d_hi),
               supernodal_m=A.shape[0], supernodal_resid=esn,
               supernodal_tol=1e-10, supernodal_symbolic_s=t_sym,
               supernodal_factor_solve_s=t_sn,
               chol_s={}, factor_inv_chol_s=_bench(fic, jnp.asarray(M)))
    for k in S["chol_sweep"] + (n,):
        Mk = jnp.asarray(M[:k, :k])
        rec["chol_s"][f"{k}/f64"] = _bench(chol, Mk)
        with jax.default_matmul_precision("highest"):
            rec["chol_s"][f"{k}/f32"] = _bench(chol32,
                                               Mk.astype(jnp.float32))
    emit(rec)
    for name, err, tol in (("cholesky f64", e64, 1e-13),
                           ("cholesky f32", e32, 1e-5),
                           ("factor_inv_chol", max(efic, einv), 1e-12),
                           ("supernodal", esn, 1e-10)):
        if not err <= tol:
            raise CheckFailed(f"kernels: {name} error {err} > {tol}")


# -- four cards --------------------------------------------------------------


def _sharding_report(arrays):
    return {k: len(v.sharding.device_set) for k, v in arrays.items()}


def phase_four_batched(S, mesh):
    from madqp_tpu.parallel import BatchedMPCSolver

    B, n, m = S["four_batch"], S["batch_n"], S["batch_m"]
    qps = _batch_qps(B, n, m)

    def run(**kw):
        solver = BatchedMPCSolver.from_problems(qps, **BATCH_OPTS, **kw)
        return solver, solver.solve_all()

    (sh, st_sh), t_sh = _timed(run, mesh=mesh)
    (_, st_sh), warm_sh = _timed(lambda: (sh, sh.solve_all()))
    (_, st_1), t_1 = _timed(run)
    errs = []
    for a, b in zip(st_sh, st_1):
        if not (a.success and b.success):
            raise CheckFailed("four_batched: a lane failed")
        errs.append(check_r2(float(a.objective), float(b.objective))
                    ["r2_err"])
    emit(dict(phase="four_batched", lanes=B, n=n, m=m, devices=4,
              sharding_devices=_sharding_report(
                  {"c": sh.prob.c, "A": sh.prob.A, "x0": sh.x0}),
              bytes_in_use={str(d.id): (d.memory_stats() or {}).get(
                  "bytes_in_use") for d in mesh.devices.flat},
              status=1, iters=int(max(s.iter for s in st_sh)),
              cold_s=t_sh, warm_s=warm_sh, warm_data="same",
              one_card_cold_s=t_1, max_r2_err=max(errs),
              r2_tol_rel=R2_TOL))


def phase_four_two_stage(S, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from madqp_tpu.parallel.structured import solve_two_stage

    prob, lb, ub = _two_stage(S, S["four_ts_N"])
    kw = dict(print_level=40, tol=1e-8)
    shard = NamedSharding(mesh, P("batch"))
    placed = {k: jax.device_put(getattr(prob, k), shard)
              for k in ("H_s", "T_s", "W_s")}
    prob_sh = prob._replace(**placed)
    st, cold = _timed(solve_two_stage, prob_sh, lb, ub, mesh=mesh,
                      scen_axis="batch", **kw)
    check_success(st, "four_two_stage")
    st_w, warm = _timed(solve_two_stage, prob_sh, lb, ub, mesh=mesh,
                        scen_axis="batch", **kw)
    ref, t_1 = _timed(solve_two_stage, prob, lb, ub, **kw)
    check_success(ref, "four_two_stage unsharded")
    emit(dict(phase="four_two_stage", N=S["four_ts_N"], n=prob.n, m=prob.m,
              devices=4, sharding_devices=_sharding_report(placed),
              status=int(st.status), iters=st.iter, cold_s=cold,
              warm_s=warm, warm_data="same", one_card_s=t_1,
              **check_r2(float(st.objective), float(ref.objective))))


# ---------------------------------------------------------------------------


def device_header(jax):
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(smi, flush=True)
    d = jax.devices()[0]
    emit(dict(phase="device", nvidia_smi=smi.splitlines(),
              device_kind=d.device_kind, count=len(jax.devices()),
              jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
              compile_cache=jax.config.jax_compilation_cache_dir))


def require_gpu(jax):
    if jax.default_backend() != "gpu" or jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX backend "
              f"{jax.default_backend()!r}); nothing was checked",
              file=sys.stderr)
        sys.exit(2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded batched and two-stage paths "
                         "on a 4-card mesh, against their 1-card runs")
    args = ap.parse_args(argv)

    import jax

    require_gpu(jax)
    import madqp_tpu as mq  # noqa: F401  (enables x64, sets the cache dir)
    from madqp_tpu import native

    device_header(jax)
    S = SIZES
    if args.four_cards:
        if len(jax.devices()) < 4:
            print("chip_smoke: --four-cards needs 4 GPUs", file=sys.stderr)
            return 2
        mesh = jax.make_mesh((4,), ("batch",), devices=jax.devices()[:4])
        phases = [("four_batched", lambda: phase_four_batched(S, mesh)),
                  ("four_two_stage", lambda: phase_four_two_stage(S, mesh))]
    else:
        phases = [(f.__name__[6:], (lambda f=f: f(S))) for f in (
            phase_dense, phase_sparse_lp, phase_sparse_qp, phase_batched,
            phase_two_stage, phase_qp_layer, phase_kernels)]

    failed = []
    # R2 on QPs and the batched host rescue depend on the native library.
    try:
        lib = native.build()
        emit(dict(phase="native", built=True, path=os.path.basename(lib)))
    except Exception as e:  # the smoke must report it and fail
        emit(dict(phase="native", built=False, error=repr(e)))
        failed.append("native")
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
            print(f"# {name}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)
        except Exception as e:
            traceback.print_exc()
            emit(dict(phase=name, status="failed", error=repr(e)[:2000],
                      wall_s=time.perf_counter() - t0))
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
