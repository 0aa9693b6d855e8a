"""Block-angular two-stage QPs with a distributed Schur-complement KKT.

This is BASELINE config #5 and the SURVEY §5.7 sequence-parallel analog: a
two-stage stochastic program

    min  c00 + c0'x0 + 1/2 x0'H0 x0 + sum_i [ ci'xi + 1/2 xi'Hi xi ]
    s.t. A0 x0 = b0
         Ti x0 + Wi xi = bi          for each scenario i = 1..N
         bounds on x0 and each xi

whose Newton/KKT system has arrow structure.  Per iteration each scenario
factors its local condensed blocks Ui = Hi + diag(sigma_i) and
Si = Wi Ui^-1 Wi' - dc I (batched Cholesky over the scenario axis),
contributes Ci = Ti' Si^-1 Ti to the first-stage Schur complement
(the cross-scenario *reduction*; over a mesh this is the all-reduce step),
and back-substitutes locally.

The flat solver state is reused unchanged: TwoStageProblem exposes the same
c0/c/b/has_lb/has_ub + hess_mv/jac_mv/jac_rmv protocol as ProblemArrays with
variables laid out [x0; vec(x_s)] and rows [y0; vec(y_s)], so MPCKernel's
masked IPM math runs verbatim; only the KKT factorization is structured.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from ..ops.kkt import CondensedFactors, DenseCondensedKKT

# Trace-time hook: under a sharded solve, flat [x0; vec(xs)] vectors must
# stay replicated (their length is not divisible by the mesh, and the IPM
# state is replicated by design) while the stacked scenario matrices shard.
# solve_two_stage installs a with_sharding_constraint here during tracing;
# the per-scenario -> flat joins apply it, which XLA lowers to all-gathers
# of the small vector pieces over ICI.
_REPLICATE_FN = None
_REPLICATE_SHARDING = None  # NamedSharding(mesh, P()) under a sharded solve
_SCEN_SHARDING = None       # NamedSharding(mesh, P('scen')) under a sharded solve


def _replicate(x):
    return x if _REPLICATE_FN is None else _REPLICATE_FN(x)


def _to_scen(x):
    """Reshard a scenario-stacked (N, ...) array onto the mesh's scenario
    axis (no-op single-device).  Needed before vmapped factor solves: vmap
    requires consistent input shardings in explicit mode."""
    if _SCEN_SHARDING is None:
        return x
    return jax.sharding.reshard(x, _SCEN_SHARDING)


def _reduce_einsum(expr, *ops):
    """einsum whose contraction includes the sharded scenario axis: the
    output is replicated (all-reduce over the mesh).  Explicit-sharding mode
    requires naming the output sharding."""
    if _REPLICATE_SHARDING is not None:
        return jnp.einsum(expr, *ops, out_sharding=_REPLICATE_SHARDING)
    return jnp.einsum(expr, *ops)


class TwoStageProblem(NamedTuple):
    """Block-angular problem data.  Scenario blocks are stacked on a leading
    axis of size N; flat vectors follow the [x0; vec(x_s)] layout."""

    # Flat protocol fields (shared with ProblemArrays).
    c0: jax.Array        # objective constant
    c: jax.Array         # (n_tot,) = [c_0; vec(c_s)]
    b: jax.Array         # (m_tot,) = [b_0; vec(b_s)]
    has_lb: jax.Array    # (n_tot,)
    has_ub: jax.Array    # (n_tot,)
    # First-stage blocks.
    H0: Optional[jax.Array]   # (n0, n0) or None for LP
    A0: jax.Array             # (m0, n0)
    # Scenario blocks (stacked).
    H_s: Optional[jax.Array]  # (N, ns, ns) or None
    T_s: jax.Array            # (N, ms, n0)
    W_s: jax.Array            # (N, ms, ns)

    # -- layout --------------------------------------------------------------

    @property
    def n0(self) -> int:
        return self.A0.shape[1]

    @property
    def m0(self) -> int:
        return self.A0.shape[0]

    @property
    def N(self) -> int:
        return self.T_s.shape[0]

    @property
    def ns(self) -> int:
        return self.W_s.shape[2]

    @property
    def ms(self) -> int:
        return self.W_s.shape[1]

    @property
    def n(self) -> int:
        return self.n0 + self.N * self.ns

    @property
    def m(self) -> int:
        return self.m0 + self.N * self.ms

    @property
    def is_lp(self) -> bool:
        return self.H0 is None and self.H_s is None

    def split_x(self, x):
        return x[: self.n0], x[self.n0:].reshape(self.N, self.ns)

    def split_y(self, y):
        return y[: self.m0], y[self.m0:].reshape(self.N, self.ms)

    def join_x(self, x0, xs):
        return jnp.concatenate([_replicate(x0), _replicate(xs).reshape(-1)])

    def join_y(self, y0, ys):
        return jnp.concatenate([_replicate(y0), _replicate(ys).reshape(-1)])

    # -- matvec protocol -----------------------------------------------------

    def hess_mv(self, x):
        x0, xs = self.split_x(x)
        h0 = jnp.zeros_like(x0) if self.H0 is None else self.H0 @ x0
        hs = (
            jnp.zeros_like(xs)
            if self.H_s is None
            else jnp.einsum("imn,in->im", self.H_s, xs)
        )
        return self.join_x(h0, hs)

    def jac_mv(self, x):
        x0, xs = self.split_x(x)
        y0 = self.A0 @ x0
        ys = jnp.einsum("imk,k->im", self.T_s, x0) + jnp.einsum(
            "imn,in->im", self.W_s, xs
        )
        return self.join_y(y0, ys)

    def jac_rmv(self, y):
        y0, ys = self.split_y(y)
        x0 = self.A0.T @ y0 + _reduce_einsum("imk,im->k", self.T_s, ys)
        xs = jnp.einsum("imn,im->in", self.W_s, ys)
        return self.join_x(x0, xs)


class SchurFactors(NamedTuple):
    chol_U: Optional[jax.Array]  # (N, ns, ns) scenario Cholesky; None for LP
    u_diag: jax.Array            # (N, ns) sigma_s (diagonal W when LP)
    chol_S: jax.Array            # (N, ms, ms) local Schur Cholesky
    X: jax.Array                 # (N, ms, n0) = S_i^-1 T_i
    first: CondensedFactors      # first-stage condensed factors over C00
    d0: jax.Array                # (n0,) sigma_0 (kept for completeness)
    W_s: jax.Array               # (N, ms, ns) scenario recourse blocks
    T_s: jax.Array               # (N, ms, n0) scenario coupling blocks


class _FirstStageProb(NamedTuple):
    """Adapter handing the first-stage dense blocks to DenseCondensedKKT."""

    H: Optional[jax.Array]
    A: jax.Array


class SchurKKT:
    """Distributed Schur-complement KKT for TwoStageProblem.

    The cross-scenario sums (`sum over i` of Ti' Si^-1 Ti and of the rhs
    contributions) are written as reductions over the stacked scenario axis;
    under jit with the scenario axis sharded over a mesh, XLA lowers them to
    all-reduces over ICI (SURVEY §5.8).
    """

    name = "schur"
    # The explicitly-sharded reductions (_reduce_einsum's out_sharding)
    # cannot be vmapped — the MPC kernel's 2-RHS init fusion must not
    # batch this KKT's solve.
    supports_vmap_solve = False

    def __init__(self, fact_dtype=None):
        self.fact_dtype = jnp.dtype(fact_dtype) if fact_dtype else None
        self._dense = DenseCondensedKKT(fact_dtype=fact_dtype)

    def factorize(self, p: TwoStageProblem, pr_diag, del_c):
        d0, ds = p.split_x(pr_diag)
        ds = _to_scen(ds)

        # Scenario blocks: U_i = H_i + diag(sigma_i); S_i = W U^-1 W' - dc I.
        if p.H_s is None:
            chol_U = None
            Uinv_WT = jnp.swapaxes(p.W_s, 1, 2) / ds[:, :, None]  # (N, ns, ms)
            Uinv_TT = None
        else:
            U = p.H_s + jax.vmap(jnp.diag)(ds)
            chol_U = jnp.linalg.cholesky(U)
            WT = jnp.swapaxes(p.W_s, 1, 2)  # (N, ns, ms)
            Uinv_WT = jax.vmap(lambda c, r: jsl.cho_solve((c, True), r))(
                chol_U, WT
            )
        S = jnp.einsum("imn,inj->imj", p.W_s, Uinv_WT)
        S = S - del_c * jnp.eye(p.ms, dtype=S.dtype)[None]
        chol_S = jnp.linalg.cholesky(S)
        # X_i = S_i^-1 T_i  (batched triangular solves).
        X = jax.vmap(lambda c, r: jsl.cho_solve((c, True), r))(chol_S, p.T_s)

        # First-stage Schur complement C00 = H0 + diag(d0) + sum_i Ti' Si^-1 Ti.
        C_contrib = _reduce_einsum("imk,iml->kl", p.T_s, X)  # psum over i
        C00 = jnp.diag(d0) + C_contrib
        if p.H0 is not None:
            C00 = C00 + p.H0
        # Hand [C00, A0] to the dense condensed factorization: it factors
        # C00 (chol) and the second-level Schur A0 C00^-1 A0' - dc I.
        first = self._dense_factorize_firststage(C00, p.A0, del_c)

        return SchurFactors(
            chol_U=chol_U, u_diag=ds, chol_S=chol_S, X=X, first=first, d0=d0,
            W_s=p.W_s, T_s=p.T_s,
        )

    def _dense_factorize_firststage(self, C00, A0, del_c):
        chol_W, w_scale = self._dense._chol_scaled(C00)
        rhs = (w_scale[:, None] * A0.T).astype(chol_W.dtype)
        Winv_AT = w_scale[:, None] * jsl.cho_solve((chol_W, True), rhs).astype(
            A0.dtype
        )
        S0 = A0 @ Winv_AT - del_c * jnp.eye(A0.shape[0], dtype=A0.dtype)
        chol_S0, s_scale = self._dense._chol_scaled(S0)
        return CondensedFactors(
            chol_W=chol_W, w_scale=w_scale, w_diag=jnp.diagonal(C00),
            chol_S=chol_S0, s_scale=s_scale, A=A0,
        )

    def _U_solve(self, f: SchurFactors, r):
        """U_i^-1 r per scenario, r of shape (N, ns) or (N, ns, k)."""
        if f.chol_U is None:
            if r.ndim == 2:
                return r / f.u_diag
            return r / f.u_diag[:, :, None]
        if r.ndim == 2:
            return jax.vmap(
                lambda c, v: jsl.cho_solve((c, True), v)
            )(f.chol_U, r)
        return jax.vmap(lambda c, v: jsl.cho_solve((c, True), v))(f.chol_U, r)

    def solve(self, f: SchurFactors, rx, ry):
        # Recover the problem blocks from the factor shapes.
        N, ms, n0 = f.X.shape
        ns = f.u_diag.shape[1]
        m0 = f.first.A.shape[0]
        rx0, rxs = rx[:n0], _to_scen(rx[n0:].reshape(N, ns))
        ry0, rys = ry[:m0], _to_scen(ry[m0:].reshape(N, ms))

        # Local forward elimination: q_i = S_i^-1 (W_i U_i^-1 rx_i - ry_i).
        Uinv_rx = self._U_solve(f, rxs)                       # (N, ns)
        w_term = jnp.einsum("imn,in->im", f.W_s, Uinv_rx)
        q = jax.vmap(lambda c, v: jsl.cho_solve((c, True), v))(
            f.chol_S, w_term - rys
        )                                                      # (N, ms)

        # First-stage solve with reduced rhs r0 - sum_i Ti' q_i.
        TtQ = _reduce_einsum("imk,im->k", f.T_s, q)            # psum over i
        dx0, dy0 = self._first_solve(f.first, rx0 - TtQ, ry0)

        # Local back-substitution.
        dys = q + jnp.einsum("imk,k->im", f.X, dx0)            # (N, ms)
        rhs_x = rxs - jnp.einsum("imn,im->in", f.W_s, dys)
        dxs = self._U_solve(f, rhs_x)

        dx = jnp.concatenate([_replicate(dx0), _replicate(dxs).reshape(-1)])
        dy = jnp.concatenate([_replicate(dy0), _replicate(dys).reshape(-1)])
        return dx, dy

    def _first_solve(self, first: CondensedFactors, rx, ry):
        dense = self._dense
        if first.A.shape[0] == 0:
            return dense._chol_apply(first.chol_W, first.w_scale, rx, rx.dtype), ry
        rhs_y = first.A @ dense._chol_apply(
            first.chol_W, first.w_scale, rx, rx.dtype
        ) - ry
        dy = dense._chol_apply(first.chol_S, first.s_scale, rhs_y, ry.dtype)
        dx = dense._chol_apply(
            first.chol_W, first.w_scale, rx - first.A.T @ dy, rx.dtype
        )
        return dx, dy

    def factor_ok(self, f: SchurFactors):
        ok = jnp.asarray(True)
        if f.chol_U is not None:
            dU = jnp.diagonal(f.chol_U, axis1=1, axis2=2)
            ok = ok & jnp.all(jnp.isfinite(dU)) & jnp.all(dU > 0)
        else:
            ok = ok & jnp.all(f.u_diag > 0)
        dS = jnp.diagonal(f.chol_S, axis1=1, axis2=2)
        ok = ok & jnp.all(jnp.isfinite(dS)) & jnp.all(dS > 0)
        dW = jnp.diagonal(f.first.chol_W)
        ok = ok & jnp.all(jnp.isfinite(dW)) & jnp.all(dW > 0)
        if f.first.chol_S.size:
            d0 = jnp.diagonal(f.first.chol_S)
            ok = ok & jnp.all(jnp.isfinite(d0)) & jnp.all(d0 > 0)
        return ok


# ---------------------------------------------------------------------------
# Builders / drivers
# ---------------------------------------------------------------------------


def build_two_stage(
    c0_vec, A0, b0, lb0, ub0,
    c_s, T_s, W_s, b_s, lb_s, ub_s,
    H0=None, H_s=None, c_const=0.0, dtype=jnp.float64,
):
    """Assemble a TwoStageProblem from block data (equality-form rows,
    +-inf bounds).  Returns (problem, lb_flat, ub_flat) with sanitized
    bounds + masks following the models.qp convention."""
    as_dev = lambda v: jnp.asarray(np.asarray(v), dtype)
    lb_flat = np.concatenate([np.asarray(lb0), np.asarray(lb_s).reshape(-1)])
    ub_flat = np.concatenate([np.asarray(ub0), np.asarray(ub_s).reshape(-1)])
    has_lb = np.isfinite(lb_flat)
    has_ub = np.isfinite(ub_flat)
    lb_flat = np.where(has_lb, lb_flat, 0.0)
    ub_flat = np.where(has_ub, ub_flat, 0.0)

    prob = TwoStageProblem(
        c0=as_dev(c_const),
        c=jnp.concatenate([as_dev(c0_vec), as_dev(c_s).reshape(-1)]),
        b=jnp.concatenate([as_dev(b0), as_dev(b_s).reshape(-1)]),
        has_lb=jnp.asarray(has_lb),
        has_ub=jnp.asarray(has_ub),
        H0=None if H0 is None else as_dev(H0),
        A0=as_dev(A0),
        H_s=None if H_s is None else as_dev(H_s),
        T_s=as_dev(T_s),
        W_s=as_dev(W_s),
    )
    return prob, as_dev(lb_flat), as_dev(ub_flat)


def two_stage_to_flat_qp(p: TwoStageProblem, lb, ub):
    """Materialize the equivalent flat dense QP (for oracle testing)."""
    from ..models.qp import QuadraticProblem

    n0, ns, ms, m0, N = p.n0, p.ns, p.ms, p.m0, p.N
    n, m = p.n, p.m
    A = np.zeros((m, n))
    A[:m0, :n0] = np.asarray(p.A0)
    for i in range(N):
        r0 = m0 + i * ms
        A[r0:r0 + ms, :n0] = np.asarray(p.T_s[i])
        c0_ = n0 + i * ns
        A[r0:r0 + ms, c0_:c0_ + ns] = np.asarray(p.W_s[i])
    H = None
    if not p.is_lp:
        H = np.zeros((n, n))
        if p.H0 is not None:
            H[:n0, :n0] = np.asarray(p.H0)
        if p.H_s is not None:
            for i in range(N):
                c0_ = n0 + i * ns
                H[c0_:c0_ + ns, c0_:c0_ + ns] = np.asarray(p.H_s[i])
    b = np.asarray(p.b)
    lb_inf = np.where(np.asarray(p.has_lb), np.asarray(lb), -np.inf)
    ub_inf = np.where(np.asarray(p.has_ub), np.asarray(ub), np.inf)
    return QuadraticProblem(
        c=np.asarray(p.c),
        A=A,
        H=H,
        c0=float(p.c0),
        lcon=b,
        ucon=b,
        lvar=lb_inf,
        uvar=ub_inf,
        name="two_stage_flat",
    )


def random_two_stage(
    n0=8, ns=6, ms=4, m0=3, N=16, seed=0, qp=True
):
    """Random feasible two-stage stochastic QP generator."""
    rng = np.random.default_rng(seed)
    A0 = rng.standard_normal((m0, n0))
    T_s = rng.standard_normal((N, ms, n0)) / np.sqrt(n0)
    W_s = rng.standard_normal((N, ms, ns)) + 2.0 * np.eye(ms, ns)[None]
    x0_feas = rng.uniform(0.2, 0.8, size=n0)
    xs_feas = rng.uniform(0.2, 0.8, size=(N, ns))
    b0 = A0 @ x0_feas
    b_s = np.einsum("imk,k->im", T_s, x0_feas) + np.einsum(
        "imn,in->im", W_s, xs_feas
    )
    c0_vec = rng.standard_normal(n0)
    c_s = rng.standard_normal((N, ns)) / N
    H0 = H_s = None
    if qp:
        P0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
        H0 = P0.T @ P0 + 0.2 * np.eye(n0)
        Ps = rng.standard_normal((N, ns, ns)) / np.sqrt(ns)
        H_s = np.einsum("inm,ink->imk", Ps, Ps) + 0.2 * np.eye(ns)[None]
        H_s = H_s / N
    lb0 = np.zeros(n0)
    ub0 = np.full(n0, 5.0)
    lb_s = np.zeros((N, ns))
    ub_s = np.full((N, ns), 5.0)
    return build_two_stage(
        c0_vec, A0, b0, lb0, ub0, c_s, T_s, W_s, b_s, lb_s, ub_s,
        H0=H0, H_s=H_s,
    )


def solve_two_stage(
    prob: TwoStageProblem, lb, ub, mesh=None, scen_axis="scen", **options
):
    """Solve a two-stage problem with the Schur-complement KKT.

    With `mesh`, the scenario-stacked arrays are sharded over the mesh axis
    (NamedSharding); XLA turns the cross-scenario Schur reductions into
    all-reduces over the interconnect.
    """
    import time

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..solver.mpc import MPCKernel
    from ..solver import state as S
    from ..utils import Counters, ExecutionStats, Status, load_options

    opts, _ = load_options(**options)
    opts = opts.replace(kkt_system="schur")
    if mesh is None:
        # Share traces/executables across calls (same options+shapes).
        from ..solver.driver import _jitted_kernel

        solve_jit = _jitted_kernel(opts)["solve"]
    else:
        kernel = MPCKernel(opts)

    dtype = jnp.dtype(opts.dtype)
    x0 = jnp.zeros(prob.n, dtype)
    y0 = jnp.zeros(prob.m, dtype)

    from . import structured as _mod

    prev_repl = _mod._REPLICATE_FN
    if mesh is not None:
        scen_shard = NamedSharding(mesh, P(scen_axis))
        repl = NamedSharding(mesh, P())
        put = lambda arr, sh: None if arr is None else jax.device_put(arr, sh)
        prob = prob._replace(
            H_s=put(prob.H_s, scen_shard),
            T_s=put(prob.T_s, scen_shard),
            W_s=put(prob.W_s, scen_shard),
            c=jax.device_put(prob.c, repl),
            b=jax.device_put(prob.b, repl),
        )
        # Explicit-sharding meshes need reshard (a real collective), not a
        # with_sharding_constraint hint.
        _mod._REPLICATE_FN = lambda v: jax.sharding.reshard(
            v, NamedSharding(mesh, P())
        )
        _mod._REPLICATE_SHARDING = NamedSharding(mesh, P())
        _mod._SCEN_SHARDING = NamedSharding(mesh, P(scen_axis))

    try:
        if mesh is None:
            solve = solve_jit
        else:
            # Replicate every leaf of the final state inside the program:
            # GSPMD is free to leave while_loop carries sharded, and a
            # sharded leaf cannot be fetched host-side on a multi-process
            # mesh (spans non-addressable devices).
            repl_out = _mod._REPLICATE_FN

            def solve(pr, x0_, y0_, lb_, ub_):
                return jax.tree.map(repl_out,
                                    kernel.solve_from(pr, x0_, y0_, lb_, ub_))

            solve = jax.jit(solve)
        t0 = time.time()
        final = jax.block_until_ready(solve(prob, x0, y0, lb, ub))
        wall = time.time() - t0
        # NB: pass prob as an argument — a bound method would close over
        # sharded arrays, which is illegal in multi-process meshes.
        cons = np.asarray(
            jax.jit(lambda pr, x: pr.jac_mv(x))(prob, final.x)
        )
    finally:
        _mod._REPLICATE_FN = prev_repl
        _mod._REPLICATE_SHARDING = None
        _mod._SCEN_SHARDING = None

    from .batched import _STATUS_MAP

    cnt = Counters(total_time=wall, k=int(final.k))
    return ExecutionStats(
        status=_STATUS_MAP.get(int(final.status), Status.INTERNAL_ERROR),
        objective=float(final.obj_val),
        solution=np.asarray(final.x),
        constraints=cons,
        multipliers=np.asarray(final.y),
        multipliers_L=np.asarray(final.zl),
        multipliers_U=np.asarray(final.zu),
        iter=int(final.k),
        counters=cnt,
        primal_feas=float(final.inf_pr),
        dual_feas=float(final.inf_du),
        complementarity=float(final.inf_compl),
        options=opts,
    )
