"""KKT systems: the four formulations of SURVEY §2.3, dense backends.

Protocol (functional equivalent of MadNLP's AbstractKKTSystem as implemented
by the reference at src/KKT/normalkkt.jl:128-219):

  * `factorize(prob, pr_diag, del_c) -> factors`  — per-iteration numeric
    factorization (the reference's build_kkt! + factorize_wrapper!).
  * `solve(factors, rx, ry) -> (dx, dy)`          — solve the *reduced* 2x2
    system [W A'; A dc I] [dx; dy] = [rx; ry], W = H + diag(pr_diag).
  * `factor_ok(factors) -> bool scalar`           — success probe, the jit
    equivalent of `is_factorized` (src/utils.jl:54-62); feeds the
    retry-with-100x-regularization loop (src/linear_solver.jl:6-17).

Bound-dual elimination/recovery around this reduced system is formulation-
independent and lives in ops.kernels (reduce_rhs / recover_bound_duals).

All formulations produce the same Newton step in exact arithmetic; they
differ in conditioning and cost:

  * CONDENSED — block elimination: Cholesky of W (SPD: H PSD + pr_diag > 0),
    then Cholesky of the SPD Schur complement S = A W^-1 A' - dc I.  Two
    dense SPD factorizations; the primary dense path.
  * NORMAL    — LP specialization (W diagonal): S = A D A' - dc I with
    D = 1/pr_diag.  Rejects QPs like the reference (normalkkt.jl:45-48).
  * K2        — full (n+m) symmetric-indefinite augmented matrix, dense LU.
  * K2_5      — K2 with symmetric Jacobi scaling (MadNLP ScaledSparseKKT
    analog) for better conditioning.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl


# ---------------------------------------------------------------------------
# Condensed / normal-equations formulation
# ---------------------------------------------------------------------------


class CondensedFactors(NamedTuple):
    chol_W: Optional[jax.Array]   # (n, n) lower Cholesky of scaled W; None for LP
    w_scale: Optional[jax.Array]  # (n,) Jacobi scale of W (None for LP)
    w_diag: jax.Array             # (n,) pr_diag (used directly when LP)
    chol_S: jax.Array             # (m, m) lower Cholesky of scaled Schur compl.
    s_scale: jax.Array            # (m,) Jacobi scale of S
    A: jax.Array                  # (m, n) kept for the solve
    W_inv: Optional[jax.Array] = None  # explicit scaled inverses (solve_mode
    S_inv: Optional[jax.Array] = None  # 'inverse': backsolves become matvecs)
    W_iL: Optional[jax.Array] = None  # blocked path: inverse CHOLESKY factors
    S_iL: Optional[jax.Array] = None  # (M^-1 r = D iL' iL D r, two matvecs —
    #                                    forming iL'iL explicitly is an n^3
    #                                    GEMM/factorization we never need)


class DenseCondensedKKT:
    """Block-elimination (condensed) dense KKT.

    Covers both the QP condensed form and the LP normal equations
    (reference NormalKKTSystem build_kkt!/solve!, normalkkt.jl:166-205):
    with H = None, W is the diagonal pr_diag and S = A D A' - dc I.

    Mixed precision (`fact_dtype` float32): both SPD blocks are symmetrically
    Jacobi-scaled to unit diagonal (taming the barrier diagonal's 1e±8
    dynamic range) and factorized in fact_dtype; callers recover full f64
    accuracy via iterative refinement on the unreduced system (the
    reference's residual-check hook, src/linear_solver.jl:28-43).
    """

    name = "condensed"

    def __init__(self, fact_dtype=None, chol_backend: str = "xla",
                 solve_mode: str = "chol"):
        self.fact_dtype = jnp.dtype(fact_dtype) if fact_dtype else None
        self.solve_mode = solve_mode
        self.blocked = chol_backend == "blocked"

    def _blocked_inv(self, M):
        """GEMM-rich factor + INVERSE CHOLESKY FACTOR (ops/blocked_dense):
        the blocked/panel factorizations keep the O(n^3) work in matmuls
        and the explicit inverse FACTOR iL = L_chol^-1 turns every later
        backsolve into two matvecs (M^-1 r = D iL' iL D r).  The full
        inverse iL'iL is never formed — that extra n^3 GEMM costs about as
        much as the factorization itself.  Returns
        (chol_like_factor_for_factor_ok, iL, scale)."""
        from .blocked_dense import factor_inv_chol

        d = jnp.diagonal(M)
        scale = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(d), 1e-300))
        Ms = scale[:, None] * M * scale[None, :]
        if self.fact_dtype is not None and Ms.dtype != self.fact_dtype:
            Ms = Ms.astype(self.fact_dtype)
        # A non-SPD input leaves NaNs in the factor's diagonal, so
        # factor_ok's isfinite-and-positive check still detects failure.
        Lc, iL = factor_inv_chol(Ms)
        return Lc, iL, scale

    def _iL_apply(self, iL, scale, r, out_dtype):
        """M^-1 r = D (iL' (iL (D r))) with D = diag(scale); works for
        vector or matrix r (columns are independent solves)."""
        rs = scale[:, None] * r if r.ndim == 2 else scale * r
        y = iL.T @ (iL @ rs.astype(iL.dtype))
        y = y.astype(out_dtype)
        return scale[:, None] * y if r.ndim == 2 else scale * y

    def _factorize_blocked(self, prob, pr_diag, del_c):
        H, A = prob.H, prob.A
        m = A.shape[0]
        if H is None:
            chol_W, W_iL, w_scale = None, None, None
            Winv_AT = A.T / pr_diag[:, None]
        else:
            chol_W, W_iL, w_scale = self._blocked_inv(H + jnp.diag(pr_diag))
            Winv_AT = self._iL_apply(W_iL, w_scale, A.T, A.dtype)
        S = A @ Winv_AT - del_c * jnp.eye(m, dtype=A.dtype)
        chol_S, S_iL, s_scale = self._blocked_inv(S)
        return CondensedFactors(
            chol_W=chol_W, w_scale=w_scale, w_diag=pr_diag,
            chol_S=chol_S, s_scale=s_scale, A=A,
            W_iL=W_iL, S_iL=S_iL,
        )

    def _explicit_inverse(self, chol, scale):
        """Unscaled explicit inverse through the scaled factorization:
        M^-1 = D Ms^-1 D with D = diag(scale).  Triangular solves against the
        identity are one-time per factorization; afterwards every backsolve
        is a single matvec (vector triangular solves are latency-bound
        sequential sweeps)."""
        n = chol.shape[0]
        eye = jnp.eye(n, dtype=chol.dtype)
        Ms_inv = jsl.cho_solve((chol, True), eye)
        return (scale[:, None] * Ms_inv.astype(scale.dtype)) * scale[None, :]

    def _chol_scaled(self, M):
        """Jacobi-scale M to unit diagonal, factorize (optionally in
        fact_dtype).  Returns (chol, scale)."""
        d = jnp.diagonal(M)
        scale = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(d), 1e-300))
        Ms = scale[:, None] * M * scale[None, :]
        if self.fact_dtype is not None and Ms.dtype != self.fact_dtype:
            Ms = Ms.astype(self.fact_dtype)
        return jsl.cholesky(Ms, lower=True), scale

    def _chol_apply(self, chol, scale, r, out_dtype):
        """Solve M x = r through the scaled factorization."""
        rs = (scale * r).astype(chol.dtype)
        xs = jsl.cho_solve((chol, True), rs)
        return (scale * xs.astype(out_dtype))

    def factorize(self, prob, pr_diag, del_c):
        if self.blocked:
            return self._factorize_blocked(prob, pr_diag, del_c)
        H, A = prob.H, prob.A
        m = A.shape[0]
        if H is None:
            chol_W, w_scale = None, None
            Winv_AT = A.T / pr_diag[:, None]  # (n, m)
        else:
            W = H + jnp.diag(pr_diag)
            chol_W, w_scale = self._chol_scaled(W)
            rhs = (w_scale[:, None] * A.T).astype(chol_W.dtype)
            Winv_AT = (
                w_scale[:, None]
                * jsl.cho_solve((chol_W, True), rhs).astype(A.dtype)
            )
        S = A @ Winv_AT
        S = S - del_c * jnp.eye(m, dtype=A.dtype)
        chol_S, s_scale = self._chol_scaled(S)
        W_inv = S_inv = None
        if self.solve_mode == "inverse":
            if chol_W is not None:
                W_inv = self._explicit_inverse(chol_W, w_scale)
            if m > 0:
                S_inv = self._explicit_inverse(chol_S, s_scale)
        return CondensedFactors(
            chol_W=chol_W, w_scale=w_scale, w_diag=pr_diag,
            chol_S=chol_S, s_scale=s_scale, A=A,
            W_inv=W_inv, S_inv=S_inv,
        )

    def _W_solve(self, f: CondensedFactors, r):
        if f.chol_W is None:
            return r / f.w_diag
        if f.W_iL is not None:
            return self._iL_apply(f.W_iL, f.w_scale, r, r.dtype)
        if f.W_inv is not None:
            return f.W_inv @ r
        return self._chol_apply(f.chol_W, f.w_scale, r, r.dtype)

    def _S_solve(self, f: CondensedFactors, r):
        if f.S_iL is not None:
            return self._iL_apply(f.S_iL, f.s_scale, r, r.dtype)
        if f.S_inv is not None:
            return f.S_inv @ r
        return self._chol_apply(f.chol_S, f.s_scale, r, r.dtype)

    def solve(self, f: CondensedFactors, rx, ry):
        m = f.A.shape[0]
        if m == 0:
            return self._W_solve(f, rx), ry
        # (A W^-1 A' - dc I) dy = A W^-1 rx - ry
        rhs_y = f.A @ self._W_solve(f, rx) - ry
        dy = self._S_solve(f, rhs_y)
        dx = self._W_solve(f, rx - f.A.T @ dy)
        return dx, dy

    def factor_ok(self, f: CondensedFactors):
        ok = jnp.all(jnp.isfinite(jnp.diagonal(f.chol_S))) & jnp.all(
            jnp.diagonal(f.chol_S) > 0
        ) if f.chol_S.size else jnp.asarray(True)
        if f.chol_W is not None:
            dW = jnp.diagonal(f.chol_W)
            ok = ok & jnp.all(jnp.isfinite(dW)) & jnp.all(dW > 0)
        else:
            ok = ok & jnp.all(f.w_diag > 0)
        return ok


class DenseNormalKKT(DenseCondensedKKT):
    """Normal-equations KKT, LP only (reference NormalKKTSystem).

    Inertia correctness = SPD Schur complement (normalkkt.jl:132-134), which
    is exactly `factor_ok`.
    """

    name = "normal"

    def factorize(self, prob, pr_diag, del_c):
        if prob.H is not None:
            raise ValueError(
                "NormalKKT supports only linear programs "
                "(reference normalkkt.jl:45-48): Hessian must be empty."
            )
        return super().factorize(prob, pr_diag, del_c)


# ---------------------------------------------------------------------------
# K2 augmented formulation (dense LU)
# ---------------------------------------------------------------------------


class K2Factors(NamedTuple):
    lu: jax.Array
    piv: jax.Array


class K2BlockedFactors(NamedTuple):
    iLu: jax.Array    # inverse UNIT-LDL factor: K^-1 r = S iLu' D^-1 iLu S r
    d: jax.Array      # LDL pivots (inertia check + the D^-1 in solves)
    sgn: jax.Array    # expected pivot signs (+1 x n, -1 x m)
    scale: Optional[jax.Array] = None  # K2.5 Jacobi scale S (None = unscaled)


class DenseK2KKT:
    """Full augmented symmetric-indefinite system [W A'; A dc I].

    MadNLP SparseKKTSystem analog (the reference default, src/utils.jl:108).
    Backends: dense LU (default) or, with chol_backend='blocked', the
    GEMM-rich signed LDLᵀ (no pivoting — justified by quasi-definiteness
    under the IPM's regularization, same as the sparse augmented path) with
    an explicit inverse so backsolves are matvecs.
    """

    name = "k2"

    def __init__(self, fact_dtype=None, chol_backend: str = "xla"):
        self.fact_dtype = jnp.dtype(fact_dtype) if fact_dtype else None
        self.blocked = chol_backend == "blocked"

    def _factorize_blocked(self, K, m, scale=None):
        from .blocked_dense import blocked_ldl, inv_unit_lower

        nm = K.shape[0]
        if self.fact_dtype is not None and K.dtype != self.fact_dtype:
            Kf = K.astype(self.fact_dtype)
        else:
            Kf = K
        sgn = jnp.concatenate([
            jnp.ones(nm - m, Kf.dtype), -jnp.ones(m, Kf.dtype)])
        # cuDSS-style static pivot floor in f32 (refinement absorbs it);
        # meaningful only on a ~unit-diagonal matrix, i.e. under K2.5.
        floor = 1e-6 if (self.fact_dtype == jnp.float32
                         and scale is not None) else 0.0
        Lu, d = blocked_ldl(Kf, sgn=sgn, floor=floor)
        # Keep the inverse unit factor, not the full K^-1: the extra
        # (n+m)^3 GEMM i11' D^-1 i11 costs about as much as the
        # factorization itself; solves are two matvecs + a diagonal scale.
        i11 = inv_unit_lower(Lu)
        return K2BlockedFactors(iLu=i11, d=d, sgn=sgn, scale=scale)

    def _assemble(self, H, A, pr_diag, del_c):
        n = pr_diag.shape[0]
        m = A.shape[0]
        dtype = pr_diag.dtype
        W = jnp.diag(pr_diag) if H is None else H + jnp.diag(pr_diag)
        K = jnp.zeros((n + m, n + m), dtype=dtype)
        K = K.at[:n, :n].set(W)
        K = K.at[:n, n:].set(A.T)
        K = K.at[n:, :n].set(A)
        K = K.at[n:, n:].set(del_c * jnp.eye(m, dtype=dtype))
        return K

    def factorize(self, prob, pr_diag, del_c):
        K = self._assemble(prob.H, prob.A, pr_diag, del_c)
        if self.blocked:
            return self._factorize_blocked(K, prob.A.shape[0])
        if self.fact_dtype is not None and K.dtype != self.fact_dtype:
            K = K.astype(self.fact_dtype)
        lu, piv = jsl.lu_factor(K)
        return K2Factors(lu=lu, piv=piv)

    def solve(self, f, rx, ry):
        n = rx.shape[0]
        rhs = jnp.concatenate([rx, ry])
        if isinstance(f, K2BlockedFactors):
            rs = rhs * f.scale if f.scale is not None else rhs
            y = f.iLu @ rs.astype(f.iLu.dtype)
            y = f.iLu.T @ (y / f.d)
            d = y.astype(rx.dtype)
            if f.scale is not None:
                d = d * f.scale
            return d[:n], d[n:]
        d = jsl.lu_solve((f.lu, f.piv), rhs.astype(f.lu.dtype))
        d = d.astype(rx.dtype)
        return d[:n], d[n:]

    def factor_ok(self, f):
        if isinstance(f, K2BlockedFactors):
            # pivot-sign inertia check (quasi-definite: +1 x n, -1 x m)
            return jnp.all(jnp.isfinite(f.d)) & jnp.all(f.d * f.sgn > 0.0)
        dU = jnp.diagonal(f.lu)
        return jnp.all(jnp.isfinite(dU)) & jnp.all(jnp.abs(dU) > 0.0)


class DenseK25KKT(DenseK2KKT):
    """K2.5: augmented system with symmetric Jacobi (sqrt-diagonal) scaling.

    MadNLP ScaledSparseKKTSystem analog (tested iteration-identical to K2 in
    the reference, test/runtests.jl:102-115).  We scale K -> D K D with
    D = 1/sqrt(max(|diag K|, eps)) and unscale the solution.
    """

    name = "k2.5"

    def factorize(self, prob, pr_diag, del_c):
        K = self._assemble(prob.H, prob.A, pr_diag, del_c)
        dK = jnp.abs(jnp.diagonal(K))
        scale = 1.0 / jnp.sqrt(jnp.maximum(dK, 1e-8))
        Ks = scale[:, None] * K * scale[None, :]
        if self.blocked:
            return self._factorize_blocked(Ks, prob.A.shape[0], scale=scale)
        if self.fact_dtype is not None and Ks.dtype != self.fact_dtype:
            Ks = Ks.astype(self.fact_dtype)
        lu, piv = jsl.lu_factor(Ks)
        return K25Factors(lu=lu, piv=piv, scale=scale)

    def solve(self, f, rx, ry):
        if isinstance(f, K2BlockedFactors):
            # scale folded into the explicit inverse at factorize time
            return DenseK2KKT.solve(self, f, rx, ry)
        n = rx.shape[0]
        rhs = (jnp.concatenate([rx, ry]) * f.scale).astype(f.lu.dtype)
        d = jsl.lu_solve((f.lu, f.piv), rhs).astype(rx.dtype) * f.scale
        return d[:n], d[n:]


class K25Factors(NamedTuple):
    lu: jax.Array
    piv: jax.Array
    scale: jax.Array


# ---------------------------------------------------------------------------
# Unreduced KKT operator (for residual checks; MadNLP mul! analog)
# ---------------------------------------------------------------------------


def kkt_mul(prob, del_w, del_c, x, lb, ub, has_lb, has_ub, zl, zu, v):
    """w = K v for the *unreduced* KKT operator (reference normalkkt.jl:207-219
    plus MadNLP._kktmul!), using this module's sign conventions:

        wx  = (H + dw I) vx + A' vy - vzl + vzu
        wy  = A vx + dc vy
        wzl = zl.vx + sl.vzl          (masked; 0 off-mask)
        wzu = -zu.vx + su.vzu         (masked)

    `prob` is any problem object exposing hess_mv/jac_mv/jac_rmv.
    """
    from .kernels import KKTVec, slacks

    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    wx = del_w * v.x + prob.jac_rmv(v.y) - v.zl + v.zu + prob.hess_mv(v.x)
    wy = prob.jac_mv(v.x) + del_c * v.y
    wzl = jnp.where(has_lb, zl * v.x + sl * v.zl, 0.0)
    wzu = jnp.where(has_ub, -zu * v.x + su * v.zu, 0.0)
    return KKTVec(x=wx, y=wy, zl=wzl, zu=wzu)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_KKT_REGISTRY = {
    "condensed": DenseCondensedKKT,
    "normal": DenseNormalKKT,
    "k2": DenseK2KKT,
    "k2.5": DenseK25KKT,
}


def make_kkt(name: str, fact_dtype=None, chol_backend: str = "xla",
             solve_mode: str = "chol"):
    if name == "schur":
        # Registered lazily to avoid a circular import; SchurKKT pairs with
        # parallel.structured.TwoStageProblem only.
        from ..parallel.structured import SchurKKT

        return SchurKKT(fact_dtype=fact_dtype)
    try:
        cls = _KKT_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kkt_system '{name}'; options: "
            f"{sorted(_KKT_REGISTRY) + ['schur', 'sparse-normal', 'sparse-augmented']}"
        )
    try:
        return cls(fact_dtype=fact_dtype, chol_backend=chol_backend,
                   solve_mode=solve_mode)
    except TypeError:
        return cls(fact_dtype=fact_dtype, chol_backend=chol_backend)
