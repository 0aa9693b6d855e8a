"""Fully on-device sparse QP path: augmented (K2) KKT + supernodal LDLᵀ.

Completes the sparse device story for quadratic programs (SURVEY §2.3 #1,
the reference's default SparseKKTSystem factorized with cuDSS LDL,
scripts/benchmarks_gpu.jl:41-42): the quasi-definite augmented system

    K = [ H + Σ   Aᵀ   ]      (Σ = pr_diag > 0, del_c < 0)
        [ A       δ_c I ]

is assembled on device from static scatter maps (H and A values baked into
a base vector once; only the two diagonals change per iteration) and
factorized by the level-scheduled supernodal signed LDLᵀ
(ops/sparse_chol.factorize_batched_ldl) — no pivoting, justified by
quasi-definiteness under the IPM's always-on regularization (SURVEY §7.3
hard part #1).  The pivot-sign inertia check is the reference's
is_inertia_correct generalized to the augmented system.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops import sparse_chol as SC


class SparseQPProblem(NamedTuple):
    """QP problem data with device-resident COO Jacobian and Hessian.

    Satisfies the ProblemArrays protocol consumed by MPCKernel; `h_*` hold
    the FULL symmetric Hessian (both triangles) so `hess_mv` is one
    segment-sum — empty arrays for an LP.
    """

    c0: jax.Array
    c: jax.Array
    b: jax.Array
    has_lb: jax.Array
    has_ub: jax.Array
    a_rows: jax.Array   # (nnz_a,) int32
    a_cols: jax.Array   # (nnz_a,) int32
    a_vals: jax.Array   # (nnz_a,)
    h_rows: jax.Array   # (nnz_h,) int32 — full symmetric
    h_cols: jax.Array   # (nnz_h,) int32
    h_vals: jax.Array   # (nnz_h,)
    # Device-resident symbolic index bundle (see SparseLPProblem.idx):
    # injected by the jit wrappers; None => host numpy constants.
    idx: Optional[dict] = None

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def is_lp(self) -> bool:
        return self.h_vals.shape[0] == 0

    @property
    def H(self):
        return None if self.is_lp else self

    def hess_mv(self, x):
        if self.is_lp:
            return jnp.zeros_like(x)
        return jax.ops.segment_sum(
            self.h_vals * x[self.h_cols], self.h_rows, num_segments=self.n
        )

    def jac_mv(self, x):
        return jax.ops.segment_sum(
            self.a_vals * x[self.a_cols], self.a_rows, num_segments=self.m
        )

    def jac_rmv(self, y):
        return jax.ops.segment_sum(
            self.a_vals * y[self.a_rows], self.a_cols, num_segments=self.n
        )


class DeviceSparseAugmentedKKT:
    """Augmented (K2) KKT with on-device assembly + supernodal signed LDLᵀ.

    Handles LP and QP (the reference's SparseKKTSystem role).  All static
    values (H, A) are baked into a base value vector at construction; per
    iteration only the Σ and δ_c diagonals are scattered in.
    """

    name = "sparse-augmented(device)"

    def __init__(self, H: Optional[sp.spmatrix], A: sp.spmatrix,
                 order: str = "auto", max_supernode: int = 128,
                 fact_dtype=None, pivot_floor: Optional[float] = None,
                 inverse: bool = False, schedule_mode: str = "greedy"):
        self.fact_dtype = jnp.dtype(fact_dtype) if fact_dtype else None
        self.inverse = inverse
        if pivot_floor is None:
            # After K2.5 scaling |diag| ~ 1, so an absolute floor near the
            # factorization dtype's sqrt(eps) is the right perturbation
            # magnitude (cuDSS-style; refinement absorbs it).
            pivot_floor = 1e-6 if self.fact_dtype == jnp.float32 else 0.0
        self.pivot_floor = float(pivot_floor)
        A = sp.csc_matrix(A)
        A.sum_duplicates()
        A = A.sorted_indices()
        m, n = A.shape
        self.m, self.n = m, n
        Acoo = A.tocoo()
        self.coo_rows = Acoo.row.astype(np.int32)
        self.coo_cols = Acoo.col.astype(np.int32)
        self.coo_vals = Acoo.data.copy()

        if H is not None:
            H = sp.csc_matrix(H)
            H.sum_duplicates()
            H = H.sorted_indices()
            if H.nnz == 0:
                H = None
        self.H = H

        # K pattern (lower triangle realized through the symmetric full).
        W_pat = sp.eye(n, format="csc")
        if H is not None:
            Hb = H.copy()
            Hb.data = np.ones_like(Hb.data)
            W_pat = (W_pat + Hb).tocsc()
        K_pat = sp.bmat(
            [[W_pat, A.T], [A, sp.eye(m, format="csc")]], format="csc"
        )
        K_pat.sum_duplicates()

        # Canonical upper-CSC of the K pattern -> position lookup.
        U = sp.triu(K_pat.tocsr(), k=0, format="csc").sorted_indices()
        pos = {}
        for j in range(n + m):
            for p in range(U.indptr[j], U.indptr[j + 1]):
                pos[(int(U.indices[p]), j)] = p
        self.nnz_up = int(U.nnz)

        # Base-value scatter maps: H/A values are read from the TRACED
        # problem arrays each factorize (not baked as constants) so one
        # jitted kernel serves every problem with this sparsity pattern
        # (see sparse_common.get_sparse_kernel).  h_sel selects the upper
        # triangle (row<=col once each) out of the full symmetric H COO.
        if H is not None:
            Hcoo = H.tocoo()  # canonical CSC order — matches prob.h_vals
            sel = Hcoo.row <= Hcoo.col
            self.h_sel = np.flatnonzero(sel).astype(np.int32)
            self.h_pos = np.asarray(
                [pos[(int(i), int(j))]
                 for i, j in zip(Hcoo.row[sel], Hcoo.col[sel])], np.int32)
        else:
            self.h_sel = np.zeros(0, np.int32)
            self.h_pos = np.zeros(0, np.int32)
        # A entry (r, c) sits at lower (n + r, c) -> upper key (c, n + r).
        self.a_pos = np.asarray(
            [pos[(int(cidx), n + int(r))]
             for r, cidx in zip(self.coo_rows, self.coo_cols)], np.int32)
        # Symbolic constants stay NUMPY (see sparse_lp).

        self.wdiag_pos = np.asarray(
            [pos[(j, j)] for j in range(n)], np.int32
        )
        self.ddiag_pos = np.asarray(
            [pos[(n + i, n + i)] for i in range(m)], np.int32
        )
        self.alldiag_pos = np.concatenate([self.wdiag_pos, self.ddiag_pos])
        # (row, col) of every upper-CSC entry, for symmetric Jacobi scaling
        # — the reference's ScaledSparseKKTSystem ("K2.5", SURVEY §2.3 #2):
        # unit |diagonal| keeps the quasi-definite LDL well-behaved in f32.
        self.entry_row = U.indices.astype(np.int32)
        self.entry_col = np.repeat(
            np.arange(n + m, dtype=np.int32), np.diff(U.indptr)
        )

        # Supernodal symbolic + value gather (permuted order) + signs.
        self.bs = SC.analyze_batched(K_pat, order=order,
                                     max_supernode=max_supernode,
                                     schedule_mode=schedule_mode)
        perm, Up, Ui = self.bs.perm, self.bs.Up, self.bs.Ui
        gmap = np.empty(len(Ui), np.int64)
        for j in range(n + m):
            gj = int(perm[j])
            for p in range(Up[j], Up[j + 1]):
                gi = int(perm[int(Ui[p])])
                a, b = (gi, gj) if gi <= gj else (gj, gi)
                gmap[p] = pos[(a, b)]
        self.value_gather = gmap
        signs = np.concatenate([np.ones(n), -np.ones(m)])
        self.expected_signs = SC.bucket_signs(self.bs, signs)
        self._device_idx = None

    def host_idx(self) -> dict:
        """Index bundle in host (numpy) form (see sparse_lp.host_idx)."""
        return dict(
            sym=self.bs, h_sel=self.h_sel, h_pos=self.h_pos,
            a_pos=self.a_pos, wdiag_pos=self.wdiag_pos,
            ddiag_pos=self.ddiag_pos, alldiag_pos=self.alldiag_pos,
            entry_row=self.entry_row, entry_col=self.entry_col,
            value_gather=self.value_gather,
        )

    def device_idx(self) -> dict:
        if self._device_idx is None:
            self._device_idx = jax.device_put(self.host_idx())
        return self._device_idx

    def factorize(self, prob: SparseQPProblem, pr_diag, del_c):
        ix = prob.idx if getattr(prob, "idx", None) is not None \
            else self.host_idx()
        kv = jnp.zeros(self.nnz_up, pr_diag.dtype)
        if self.h_pos.size:
            kv = kv.at[ix["h_pos"]].add(prob.h_vals[ix["h_sel"]])
        kv = kv.at[ix["a_pos"]].add(prob.a_vals)
        kv = kv.at[ix["wdiag_pos"]].add(pr_diag)
        kv = kv.at[ix["ddiag_pos"]].add(del_c)
        # K2.5 symmetric scaling: Ks = Ds K Ds with Ds = |diag(K)|^-1/2;
        # quasi-definiteness and pivot signs are preserved.
        kdiag = jnp.abs(kv[ix["alldiag_pos"]])
        scale = jax.lax.rsqrt(jnp.maximum(kdiag, jnp.finfo(kv.dtype).tiny))
        kv = kv * scale[ix["entry_row"]] * scale[ix["entry_col"]]
        kv = kv[ix["value_gather"]]
        if self.fact_dtype is not None and kv.dtype != self.fact_dtype:
            # Mixed precision: factorize in fact_dtype; the MPC kernel's
            # iterative refinement (max_refine_steps) recovers f64 accuracy
            # against the f64 kkt_mul operator (reference hook:
            # src/linear_solver.jl:28-43).
            kv = kv.astype(self.fact_dtype)
        return (SC.factorize_batched_ldl(
            ix["sym"], kv, signs=self.expected_signs,
            pivot_floor=self.pivot_floor, inverse=self.inverse),
            scale, ix["sym"])

    def solve(self, factors, rx, ry):
        ldl, scale, sym = factors
        rhs = jnp.concatenate([rx, ry]) * scale
        out_dtype = rhs.dtype
        if self.fact_dtype is not None and rhs.dtype != self.fact_dtype:
            rhs = rhs.astype(self.fact_dtype)
        sol = SC.solve_batched_ldl(
            sym, ldl, rhs, inverse=self.inverse).astype(out_dtype)
        sol = sol * scale
        return sol[: self.n], sol[self.n:]

    def factor_ok(self, factors):
        ldl, _scale, _sym = factors
        return SC.factor_ok_batched_ldl(ldl, self.expected_signs)


def finish_stats(qp: QuadraticProblem, info, opts, final, wall,
                 extra_iters: int = 0, std=None, ls_time=None,
                 endgame_time: float = 0.0, endgame_backend: str = ""):
    """Map the internal terminal IPM state back to user coordinates and
    package ExecutionStats (shared by the sparse device drivers).
    extra_iters: iterations spent in an earlier phase (two-phase mixed
    precision) to include in the reported count.  std: the internal
    standard form — when given, non-convergent exits are upgraded to
    certified infeasible/unbounded statuses (same as the dense driver).
    ls_time: measured cumulative factorize+backsolve seconds
    (sparse_common.measure_sparse_ls, options.measure_linear_solver) —
    None leaves the counter at its 'not measured' default."""
    from ..solver.certificates import certify_exit_status
    from ..solver.driver import _STATUS_MAP
    from ..utils import Counters, ExecutionStats, Status

    status = _STATUS_MAP.get(int(final.status), Status.INTERNAL_ERROR)
    if std is not None:
        status = certify_exit_status(
            std, np.asarray(final.x, np.float64)[: info.n],
            np.asarray(final.y, np.float64)[: info.m], status)
    x_user = info.recover_x(np.asarray(final.x, np.float64)[: info.n])
    y_user = info.recover_y(np.asarray(final.y, np.float64)[: info.m])
    g_user = qp.grad(x_user)
    r_fix = g_user + qp.jtprod(y_user)
    zl_user = info.recover_z(
        np.asarray(final.zl, np.float64)[: info.n], np.maximum(r_fix, 0.0)
    )
    zu_user = info.recover_z(
        np.asarray(final.zu, np.float64)[: info.n], np.maximum(-r_fix, 0.0)
    )
    return ExecutionStats(
        status=status,
        objective=float(qp.obj(x_user)),
        solution=x_user,
        constraints=qp.cons(x_user),
        multipliers=y_user,
        multipliers_L=zl_user,
        multipliers_U=zu_user,
        iter=int(final.k) + extra_iters,
        counters=Counters(total_time=wall, k=int(final.k) + extra_iters,
                          linear_solver_time=(ls_time if ls_time is not None
                                              else 0.0),
                          endgame_time=endgame_time,
                          endgame_backend=endgame_backend),
        primal_feas=float(final.inf_pr),
        dual_feas=float(final.inf_du),
        complementarity=float(final.inf_compl),
        options=opts,
    )


def _host_full_solve(qp, opts, t0, kkt_system="k2"):
    """Whole-solve host fallback for patterns the on-device schedule
    cannot hold (ScheduleTooLargeError).  Honest accounting: the entire
    wall is endgame_time with endgame_backend='host-full', so suite
    ratios can never read this as device time."""
    import time as _time

    from .host import HostMPCSolver

    host = HostMPCSolver(
        qp, tol=opts.tol, max_iter=opts.max_iter, max_ncorr=opts.max_ncorr,
        step_rule=opts.step_rule, regularization=opts.regularization,
        kkt_system=kkt_system, print_level=max(opts.print_level, 25),
        scaling=opts.scaling, max_gradient=opts.max_gradient,
        barrier_gate=opts.barrier_gate, mu_min=opts.mu_min,
        bound_push=opts.bound_push, bound_fac=opts.bound_fac,
        bound_relax_factor=opts.bound_relax_factor,
    )
    stats = host.solve()
    stats.counters.total_time = _time.time() - t0
    stats.counters.endgame_time = stats.counters.total_time
    stats.counters.endgame_backend = "host-full"
    return stats


def _host_endgame(qp, opts, final, info, std, t0, kkt_system="k2"):
    """Finish a two-phase solve on the HOST sparse path (endgame="host"):
    warm-start HostMPCSolver (native C++ LDL) from the device f32 phase's
    terminal iterate.  The f64 XLA program — a second large cold compile —
    never exists.  Coordinates match because
    HostMPCSolver builds the identical standard form."""
    import dataclasses
    import time as _time

    from ..utils import Status
    from .host import HostMPCSolver

    def make_host():
        return HostMPCSolver(
            qp, tol=opts.tol, max_iter=opts.max_iter,
            max_ncorr=opts.max_ncorr,
            step_rule=opts.step_rule, regularization=opts.regularization,
            kkt_system=kkt_system, print_level=max(opts.print_level, 25),
            scaling=opts.scaling, max_gradient=opts.max_gradient,
            barrier_gate=opts.barrier_gate, mu_min=opts.mu_min,
            bound_push=opts.bound_push, bound_fac=opts.bound_fac,
            bound_relax_factor=opts.bound_relax_factor,
        )

    host = make_host()
    n, m = host.prob.n, host.prob.m
    assert n == std.A.shape[1] and m == std.A.shape[0], (
        "host endgame standard form mismatch")
    wx = np.asarray(final.x, np.float64)[:n]
    wy = np.asarray(final.y, np.float64)[:m]
    wzl = np.asarray(final.zl, np.float64)[:n]
    wzu = np.asarray(final.zu, np.float64)[:n]
    warm_used = bool(np.isfinite(wx).all() and np.isfinite(wy).all()
                     and np.isfinite(wzl).all() and np.isfinite(wzu).all())
    extra = int(final.k) if warm_used else 0
    if warm_used:
        host.set_initial_point_internal(wx, wy, wzl, wzu)
    eg_t0 = _time.time()
    stats = host.solve()
    eg_backend = "host"
    if warm_used and stats.status not in (
            Status.SOLVE_SUCCEEDED,
            Status.INFEASIBLE_PROBLEM_DETECTED,
            Status.UNBOUNDED_PROBLEM_DETECTED):
        # Robustness ladder (round-5, chainqp_2000): a STALLED f32 phase
        # can hand over a finite but centrality-poisoned iterate from
        # which the host's MPC step computation fails, even though the
        # same host solves the instance cold in ~11 iterations.  Retry
        # from the host's own Mehrotra starting point — the same
        # fallback philosophy as the reference's factorization retry
        # (src/linear_solver.jl:6-17); the wasted phase-1 iterations are
        # not counted as progress.
        stats = make_host().solve()
        extra = 0
        eg_backend = "host-cold"
    stats.counters.endgame_time = _time.time() - eg_t0
    stats.counters.endgame_backend = eg_backend
    stats.counters.total_time = _time.time() - t0
    if not opts.measure_linear_solver:
        # The host accumulates factorize+solve time for ITS phase only;
        # reporting that partial scope in the standard column would read
        # as the whole solve's linear-solver share.  Without measurement
        # of the device phase (measure_linear_solver), reset to the
        # "not measured" default — the suite harness then records None.
        stats.counters.linear_solver_time = 0.0
    return dataclasses.replace(stats, iter=stats.iter + extra)


def _condensed_auto_ok(qp: QuadraticProblem, fill_cap: float = 4.0) -> bool:
    """Auto-routing guard for the condensed (K1) path.

    On inequality-dominated QPs (ineq_qp n=2k, m=4k) the n0×n0 SPD
    condensed factorization was faster than the (n0+2m)-dim quasi-definite
    K2 end to end, with about half the compile time.  Route
    "auto" there only when it is *safe and structurally favorable*:

    - no equality rows (the condensed driver relaxes them by ~tol, which
      perturbs solutions — only take the path when relaxation is a no-op);
    - every row has a finite bound (a fully free row has no barrier on its
      slack, Σs = 0, and the D = (Σs⁻¹ − δ_c)⁻¹ elimination degenerates);
    - the H + AᵀA pattern cannot blow up vs K2's: Σ_k nnz(A[k,:])² (an
      upper bound on nnz(AᵀA), tight for banded rows, huge for dense
      rows) must stay within fill_cap× the K2 triangle nnz.
    """
    m = qp.A.shape[0]
    if m == 0:
        return False
    lcon = np.asarray(qp.lcon)
    ucon = np.asarray(qp.ucon)
    lf, uf = np.isfinite(lcon), np.isfinite(ucon)
    if np.any(lf & uf & (lcon == ucon)):
        return False
    if np.any(~lf & ~uf):
        return False
    A = qp.A.tocsr()
    row_nnz = np.diff(A.indptr)
    ata_bound = float(np.square(row_nnz, dtype=np.float64).sum())
    nnz_h = qp.H.nnz if qp.H is not None else 0
    k2_nnz = float(nnz_h + A.nnz + A.shape[1] + 2 * m)
    return ata_bound + nnz_h <= fill_cap * k2_nnz


def solve_sparse_qp(qp: QuadraticProblem, order: str = "auto",
                    kkt_system: str = "augmented", **options):
    """Solve a (large sparse) LP or QP fully on device.

    kkt_system: "augmented" (default) — K2 supernodal signed LDLᵀ (any
    QP); "normal" — normal equations (LP / diagonal-Hessian QP only;
    m×m SPD Cholesky, smaller and pivot-free); "condensed" — K1 slack/dual
    elimination (SPD n0×n0, general Hessian, equality rows relaxed);
    "auto" — normal when the Hessian is absent or diagonal, condensed for
    inequality-dominated non-diagonal-H QPs (no equality rows, bounded
    AᵀA fill — see _condensed_auto_ok), augmented otherwise.  Returns
    ExecutionStats like mq.solve."""
    from ..solver.mpc import MPCKernel
    from ..utils import load_options

    # dense-path spellings (K2.5 scaling is built into the sparse KKTs)
    kkt_system = {"k2": "augmented", "k2.5": "augmented",
                  "scaled": "augmented"}.get(kkt_system, kkt_system)
    if kkt_system not in ("auto", "augmented", "normal", "condensed"):
        raise ValueError(f"kkt_system={kkt_system!r}: "
                         "expected auto|augmented|normal|condensed")
    if kkt_system == "condensed":
        from .sparse_condensed import solve_sparse_condensed

        return solve_sparse_condensed(qp, order=order, **options)
    if kkt_system != "augmented":
        Hd = qp.H
        diag_h = Hd is None or (
            (lambda c: (c.row == c.col).all())(sp.coo_matrix(Hd)))
        if kkt_system == "normal" and not diag_h:
            raise ValueError(
                "kkt_system='normal' needs an LP or diagonal Hessian.")
        if diag_h:
            from .sparse_lp import solve_sparse_lp

            return solve_sparse_lp(qp, order=order, **options)
        if kkt_system == "auto" and _condensed_auto_ok(qp):
            from .sparse_condensed import solve_sparse_condensed

            return solve_sparse_condensed(qp, order=order, **options)

    from .sparse_common import (canonical_coo_vals, get_sparse_kernel,
                                resolve_endgame,
                                pattern_fingerprint, stepped_solve)

    opts, _ = load_options(**options)
    opts = resolve_endgame(opts)
    std, info, x0, y0 = build_standard_form_sparse(
        qp, scaling=opts.scaling, max_gradient=opts.max_gradient
    )
    fp = pattern_fingerprint(std.A, std.H)

    def kernel_for(o):
        # Pattern-keyed kernel reuse (see sparse_common): H/A values flow
        # in through the traced problem arrays, so one jit serves every
        # problem with this sparsity.
        return get_sparse_kernel(
            f"qp:{order}", fp, o,
            lambda: DeviceSparseAugmentedKKT(
                std.H, std.A, order=order,
                fact_dtype=o.factorization_dtype or None,
                inverse=(o.solve_mode == "inverse"),
                schedule_mode=o.sparse_schedule,
            ),
        )

    two_phase = (opts.factorization_dtype == "float32"
                 and opts.precision_scheme == "two-phase"
                 and opts.tol < opts.phase1_tol)
    if two_phase:
        from .sparse_common import two_phase_opts
        opts1, opts2 = two_phase_opts(opts, typed_phase1=True)
    else:
        opts1, opts2 = opts, None

    try:
        kkt, kernel, jits = kernel_for(opts1)
    except SC.ScheduleTooLargeError:
        # High-fill pattern (e.g. a 2-D-grid Laplacian's ND fill): the
        # flat scatter-map schedule would exceed the update-traffic cap
        # — the whole solve runs on the host sparse path instead of
        # OOM-killing the process.
        return _host_full_solve(qp, opts, time.time())

    def make_arrays(dt):
        """Problem pytree + bounds + starting point at dtype dt (phase 1
        may run fully in f32 — options.phase1_dtype; the endgame needs
        the f64 twin).  Assembled as NUMPY and shipped with ONE
        device_put instead of one transfer per array."""
        dt = np.dtype(str(jnp.dtype(dt)))
        if kkt.H is not None:
            Hcoo = kkt.H.tocoo()
            h_rows = Hcoo.row.astype(np.int32)
            h_cols = Hcoo.col.astype(np.int32)
            h_vals = canonical_coo_vals(std.H).astype(dt)
        else:
            h_rows = np.zeros((0,), np.int32)
            h_cols = np.zeros((0,), np.int32)
            h_vals = np.zeros((0,), dt)
        p = SparseQPProblem(
            c0=np.asarray(std.c0, dt),
            c=np.asarray(std.c, dt),
            b=np.asarray(std.b, dt),
            has_lb=np.asarray(std.has_lb),
            has_ub=np.asarray(std.has_ub),
            a_rows=np.asarray(kkt.coo_rows),
            a_cols=np.asarray(kkt.coo_cols),
            a_vals=canonical_coo_vals(std.A).astype(dt),
            h_rows=h_rows,
            h_cols=h_cols,
            h_vals=h_vals,
        )
        return jax.device_put(
            (p, np.asarray(std.lb, dt), np.asarray(std.ub, dt),
             np.asarray(x0, dt), np.asarray(y0, dt)))

    prob, lb, ub, x0j, y0j = make_arrays(opts1.dtype)
    t0 = time.time()
    # f32 matmuls at default precision may run in TF32 on tensor-core GPUs
    # — fatal for an f32 factorization.  Force full-f32 products while
    # tracing the solve (see sparse_lp).
    host_endgame = two_phase and opts.endgame == "host"
    # loop_mode='auto' dispatches bounded chunks (run_k) instead of
    # per-iteration stepping, amortizing the per-dispatch host sync.
    style = {"python": "stepped", "jit": "jit"}.get(opts.loop_mode,
                                                    "chunked")
    stepped = style in ("stepped", "chunked")
    with jax.default_matmul_precision("highest"):
        finish2 = None
        if two_phase and opts2 is not None and opts2.krylov_solve:
            # The augmented KKT has no SPD reduction, so endgame="krylov"
            # falls back to the f64 refactorization here.
            opts2 = dataclasses.replace(
                opts2, krylov_solve=False, factorization_dtype="")
        if two_phase and not host_endgame and not stepped:
            # Overlap the endgame compile with phase 1 (see sparse_lp).
            from .sparse_common import start_phase2_overlap

            prob2, lb2, ub2, x02, y02 = make_arrays(opts2.dtype)
            ones_n = jnp.ones_like(x02)
            finish2 = start_phase2_overlap(
                kernel_for, opts2,
                (prob2, x02, y02, ones_n, ones_n, lb2, ub2))
        if style == "chunked":
            from .sparse_common import chunked_solve

            final = chunked_solve(jits, prob, x0j, y0j, lb, ub, chunk=8)
        elif style == "stepped":
            final = stepped_solve(jits, prob, x0j, y0j, lb, ub)
        else:
            final = jax.block_until_ready(
                jits["solve"](prob, x0j, y0j, lb, ub)
            )
        extra = 0
        ls_time = None
        if opts.measure_linear_solver:
            from .sparse_common import measure_sparse_ls

            ls_time = measure_sparse_ls(kkt, prob, final, lb, ub)
        if host_endgame:
            stats = _host_endgame(qp, opts, final, info, std, t0,
                                  kkt_system="k2")
            if ls_time is not None:
                stats.counters.linear_solver_time += ls_time
            return stats
        eg_time = 0.0
        eg_backend = ""
        if two_phase:
            # f64 endgame warm-started from the f32 phase (see sparse_lp).
            eg_t0 = time.time()
            eg_backend = "device-f64"
            extra = int(final.k)
            dt2 = jnp.dtype(opts2.dtype)
            wx, wy = final.x.astype(dt2), final.y.astype(dt2)
            wzl, wzu = final.zl.astype(dt2), final.zu.astype(dt2)
            if style == "chunked":
                from .sparse_common import chunked_solve

                prob2, lb2, ub2, _, _ = make_arrays(opts2.dtype)
                _, _, jits2 = kernel_for(opts2)
                final = chunked_solve(jits2, prob2, wx, wy, lb2, ub2,
                                      warm=(wzl, wzu), chunk=4)
            elif style == "stepped":
                prob2, lb2, ub2, _, _ = make_arrays(opts2.dtype)
                _, _, jits2 = kernel_for(opts2)
                final = stepped_solve(jits2, prob2, wx, wy, lb2, ub2,
                                      warm=(wzl, wzu))
            else:
                final = jax.block_until_ready(
                    finish2(prob2, wx, wy, wzl, wzu, lb2, ub2)
                )
            eg_time = time.time() - eg_t0
            if ls_time is not None:
                from .sparse_common import measure_sparse_ls

                kkt2, _, _ = kernel_for(opts2)
                ls_time += measure_sparse_ls(kkt2, prob2, final, lb2, ub2)
    wall = time.time() - t0
    return finish_stats(qp, info, opts, final, wall, extra_iters=extra,
                        std=std, ls_time=ls_time,
                        endgame_time=eg_time, endgame_backend=eg_backend)
