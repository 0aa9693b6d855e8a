"""Fully on-device sparse *condensed* (K1) KKT path.

Completes the KKT zoo (SURVEY §2.3 #3): the reference supports MadNLP's
``SparseCondensedKKTSystem`` behind ``RelaxBound``/``RelaxEquality``
treatments (src/utils.jl:81-82) but never exercises it in tests.  Here it
is a first-class sparse device formulation: after relaxing equality rows
(RelaxEquality semantics) every constraint row carries a bounded slack, so
the standard form is ``A x_int = 0`` with ``A = [A0, -I]``.  Eliminating
the slack block and the constraint duals from the augmented (K2) system

    [ H0+Σx   0     A0ᵀ  ] [Δx]   [rx]
    [ 0       Σs    -I   ] [Δs] = [rs]        (Σ > 0, δ_c ≤ 0)
    [ A0      -I    δ_c I] [Δy]   [ry]

gives the SPD n0×n0 condensed system

    C Δx = rx + A0ᵀ D (ry + Σs⁻¹ rs),   C = H0 + Σx + A0ᵀ D A0,
    D = (Σs⁻¹ − δ_c)⁻¹ > 0,
    Δy = D (A0 Δx − ry − Σs⁻¹ rs),      Δs = Σs⁻¹ (rs + Δy).

C is SPD — pivot-free supernodal Cholesky (the accelerator-friendly property the
normal-equations path enjoys), with pattern H0 + A0ᵀA0 fixed at
construction.  For inequality-dominated QPs with m > n0 it is smaller than
both K2 ((n+m)²) and the normal equations (m×m), and unlike the normal
path it takes *general* (non-diagonal) Hessians.

Assembly reuses the contribution-pair machinery of DeviceSparseNormalKKT
(solver/sparse_lp.py) transposed: pairs run over *rows* of A0 instead of
columns, accumulating A0[k,i]·D_k·A0[k,j] by segment-sum (deterministic,
SURVEY §5.2).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops import sparse_chol as SC


class DeviceSparseCondensedKKT:
    """Condensed (K1) KKT over the structural variables only.

    Requires the internal standard form in which EVERY row has a slack
    (``A_int = [A0, -I]``, slack j ↔ row j) — the driver below guarantees
    it by relaxing equality rows first.  Implements the same
    factorize/solve/factor_ok protocol as the other sparse device KKTs;
    ``rx`` spans the full internal primal (structural + slack) block.
    """

    name = "sparse-condensed(device)"

    def __init__(self, H0: Optional[sp.spmatrix], A0: sp.spmatrix,
                 order: str = "auto", max_supernode: int = 128,
                 fact_dtype=None, pivot_floor: Optional[float] = None,
                 inverse: bool = False, krylov: bool = False,
                 krylov_tol: float = 1e-12, krylov_maxit: int = 64,
                 schedule_mode: str = "greedy"):
        self.fact_dtype = jnp.dtype(fact_dtype) if fact_dtype else None
        self.inverse = inverse
        # PCG endgame: f32 factor as preconditioner, f64 matvecs only
        # (see sparse_lp.DeviceSparseNormalKKT / options.endgame).
        self.krylov = krylov
        self.krylov_tol = float(krylov_tol)
        self.krylov_maxit = int(krylov_maxit)
        A0 = sp.csc_matrix(A0)
        A0.sum_duplicates()
        A0 = A0.sorted_indices()
        m, n0 = A0.shape
        self.m, self.n0 = m, n0
        A0coo = A0.tocoo()  # canonical CSC order — matches prob.a_vals[:nnz0]
        self.nnz0 = int(A0.nnz)
        self.a0_rows = A0coo.row.astype(np.int32)
        self.a0_cols = A0coo.col.astype(np.int32)

        if H0 is not None:
            H0 = sp.csc_matrix(H0)
            H0.sum_duplicates()
            H0 = H0.sorted_indices()
            if H0.nnz == 0:
                H0 = None
        self.H0 = H0

        # Pattern of C = H0 + I + A0ᵀA0.
        Abool = A0.copy()
        Abool.data = np.ones_like(Abool.data)
        C_pat = (Abool.T @ Abool + sp.eye(n0)).tocsc()
        if H0 is not None:
            Hb = H0.copy()
            Hb.data = np.ones_like(Hb.data)
            C_pat = (C_pat + Hb).tocsc()
        C_pat.sum_duplicates()

        # Canonical upper-CSC of C — the value array the factorization
        # consumes — with an (i, j) -> position lookup.
        U = sp.triu(C_pat.tocsr(), k=0, format="csc").sorted_indices()
        pos = {}
        for j in range(n0):
            for p in range(U.indptr[j], U.indptr[j + 1]):
                pos[(int(U.indices[p]), j)] = p
        self.nnz_up = int(U.nnz)

        # Contribution pairs over ROWS of A0: row k with columns J_k gives
        # A0[k,i]·D_k·A0[k,j] into C_ij for every i >= j in J_k × J_k.
        # p/q address the canonical-CSC value array (prob.a_vals order): a
        # CSR sweep with CSC positions as payload recovers them.
        Apos = sp.csc_matrix(
            (np.arange(self.nnz0, dtype=np.int64), A0.indices, A0.indptr),
            shape=A0.shape,
        ).tocsr()
        indptr, cols, cpos = Apos.indptr, Apos.indices, Apos.data
        pair_p, pair_q, pair_k, pair_e = [], [], [], []
        for k in range(m):
            lo, hi = indptr[k], indptr[k + 1]
            for a in range(lo, hi):
                ia = int(cols[a])
                for bq in range(lo, hi):
                    jb = int(cols[bq])
                    if jb > ia:
                        continue  # lower (ia >= jb); upper key is (jb, ia)
                    pair_p.append(int(cpos[a]))
                    pair_q.append(int(cpos[bq]))
                    pair_k.append(k)
                    pair_e.append(pos[(jb, ia)])
        # Symbolic constants stay NUMPY (see sparse_lp).
        self.pair_p = np.asarray(pair_p, np.int32)
        self.pair_q = np.asarray(pair_q, np.int32)
        self.pair_k = np.asarray(pair_k, np.int32)
        self.pair_e = np.asarray(pair_e, np.int32)

        # H0 upper-triangle scatter out of the full-symmetric canonical COO
        # (prob.h_vals order — block_diag(H0, 0) canonicalizes to H0's CSC).
        if H0 is not None:
            Hcoo = H0.tocoo()
            sel = Hcoo.row <= Hcoo.col
            self.h_sel = np.flatnonzero(sel).astype(np.int32)
            self.h_pos = np.asarray(
                [pos[(int(i), int(j))]
                 for i, j in zip(Hcoo.row[sel], Hcoo.col[sel])], np.int32)
        else:
            self.h_sel = np.zeros(0, np.int32)
            self.h_pos = np.zeros(0, np.int32)

        self.diag_pos = np.asarray([pos[(j, j)] for j in range(n0)], np.int32)
        # (row, col) of every upper entry for symmetric Jacobi (K2.5) scaling.
        self.entry_row = U.indices.astype(np.int32)
        self.entry_col = np.repeat(
            np.arange(n0, dtype=np.int32), np.diff(U.indptr)
        )

        # Supernodal symbolic over C; static gather into permuted order.
        self.symb = SC.analyze_batched(C_pat, order=order,
                                       max_supernode=max_supernode,
                                       schedule_mode=schedule_mode)
        perm, Up, Ui = self.symb.perm, self.symb.Up, self.symb.Ui
        gmap = np.empty(len(Ui), np.int32)
        for j in range(n0):
            gj = int(perm[j])
            for p in range(Up[j], Up[j + 1]):
                gi = int(perm[int(Ui[p])])
                a, b = (gi, gj) if gi <= gj else (gj, gi)
                gmap[p] = pos[(a, b)]
        self.value_gather = gmap

        # f32: pivot-floored LDL with all-+1 signs (same rationale as the
        # normal path — plain f32 Cholesky of a cond~1e8 SPD matrix breaks).
        self.use_ldl = self.fact_dtype == jnp.float32
        if self.use_ldl:
            self.expected_signs = SC.bucket_signs(self.symb, np.ones(n0))
            self.pivot_floor = (1e-6 if pivot_floor is None
                                else float(pivot_floor))
        self._device_idx = None

    def host_idx(self) -> dict:
        """Index bundle in host (numpy) form (see sparse_lp.host_idx)."""
        return dict(
            sym=self.symb, pair_p=self.pair_p, pair_q=self.pair_q,
            pair_k=self.pair_k, pair_e=self.pair_e, h_sel=self.h_sel,
            h_pos=self.h_pos, diag_pos=self.diag_pos,
            entry_row=self.entry_row, entry_col=self.entry_col,
            value_gather=self.value_gather, a0_rows=self.a0_rows,
            a0_cols=self.a0_cols,
        )

    def device_idx(self) -> dict:
        if self._device_idx is None:
            self._device_idx = jax.device_put(self.host_idx())
        return self._device_idx

    def factorize(self, prob, pr_diag, del_c):
        ix = prob.idx if getattr(prob, "idx", None) is not None \
            else self.host_idx()
        n0 = self.n0
        sig_x = pr_diag[:n0]
        sig_s = pr_diag[n0:]
        # D = (Σs⁻¹ − δ_c)⁻¹ = Σs / (1 − δ_c Σs); δ_c ≤ 0 keeps it positive.
        D = sig_s / (1.0 - del_c * sig_s)
        a0_vals = prob.a_vals[: self.nnz0]
        contrib = (a0_vals[ix["pair_p"]] * D[ix["pair_k"]]
                   * a0_vals[ix["pair_q"]])
        c_vals = jax.ops.segment_sum(
            contrib, ix["pair_e"], num_segments=self.nnz_up
        )
        if self.h_pos.size:
            c_vals = c_vals.at[ix["h_pos"]].add(prob.h_vals[ix["h_sel"]])
        c_vals = c_vals.at[ix["diag_pos"]].add(sig_x)
        # Symmetric Jacobi scaling to unit diagonal (K2.5 analog).
        c_diag = c_vals[ix["diag_pos"]]
        scale = jax.lax.rsqrt(
            jnp.maximum(c_diag, jnp.finfo(c_diag.dtype).tiny))
        c_vals = c_vals * scale[ix["entry_row"]] * scale[ix["entry_col"]]
        c_vals = c_vals[ix["value_gather"]]
        if self.fact_dtype is not None and c_vals.dtype != self.fact_dtype:
            # Mixed precision: the MPC kernel's iterative refinement against
            # the f64 kkt_mul recovers accuracy (src/linear_solver.jl:28-43).
            c_vals = c_vals.astype(self.fact_dtype)
        if self.use_ldl:
            panels = SC.factorize_batched_ldl(
                ix["sym"], c_vals, signs=self.expected_signs,
                pivot_floor=self.pivot_floor, inverse=self.inverse)
        else:
            panels = SC.factorize_batched(ix["sym"], c_vals,
                                          inverse=self.inverse)
        return (panels, D, sig_s, sig_x, scale, prob)

    def _a0_mv(self, prob, ix, x):
        a0_vals = prob.a_vals[: self.nnz0]
        return jax.ops.segment_sum(
            a0_vals * x[ix["a0_cols"]], ix["a0_rows"], num_segments=self.m
        )

    def _a0_rmv(self, prob, ix, y):
        a0_vals = prob.a_vals[: self.nnz0]
        return jax.ops.segment_sum(
            a0_vals * y[ix["a0_rows"]], ix["a0_cols"], num_segments=self.n0
        )

    def _apply_factor(self, sym, panels, rhs):
        out_dtype = rhs.dtype
        if self.fact_dtype is not None and rhs.dtype != self.fact_dtype:
            rhs = rhs.astype(self.fact_dtype)
        if self.use_ldl:
            dx0 = SC.solve_batched_ldl(sym, panels, rhs,
                                       inverse=self.inverse)
        else:
            dx0 = SC.solve_batched(sym, panels, rhs,
                                   inverse=self.inverse)
        return dx0.astype(out_dtype)

    def solve(self, factors, rx, ry):
        panels, D, sig_s, sig_x, scale, prob = factors
        ix = prob.idx if getattr(prob, "idx", None) is not None \
            else self.host_idx()
        sym = ix["sym"]
        n0 = self.n0
        rx0 = rx[:n0]
        rs = rx[n0:]
        w = D * (ry + rs / sig_s)
        rhs = (rx0 + self._a0_rmv(prob, ix, w)) * scale
        if self.krylov:
            # f64 PCG on the scaled SPD condensed matrix
            # Cs = Ds (H0 + Sig_x + A0' D A0) Ds, f32 factor as M^-1.
            from ..ops.krylov import pcg

            def matvec(v):
                u = scale * v
                un = jnp.concatenate([u, jnp.zeros(self.m, u.dtype)])
                h = prob.hess_mv(un)[:n0]
                return scale * (
                    h + sig_x * u
                    + self._a0_rmv(prob, ix, D * self._a0_mv(prob, ix, u)))

            dx0, _k = pcg(matvec,
                          lambda r: self._apply_factor(sym, panels, r),
                          rhs, tol_rel=self.krylov_tol,
                          maxit=self.krylov_maxit)
        else:
            dx0 = self._apply_factor(sym, panels, rhs)
        dx0 = dx0 * scale
        dy = D * (self._a0_mv(prob, ix, dx0) - ry - rs / sig_s)
        ds = (rs + dy) / sig_s
        return jnp.concatenate([dx0, ds]), dy

    def factor_ok(self, factors):
        panels, D, _sig_s, _sig_x, _scale, _prob = factors
        ok = jnp.all(D > 0)
        if self.use_ldl:
            return ok & SC.factor_ok_batched_ldl(panels, self.expected_signs)
        return ok & SC.factor_ok_batched(panels)


def relax_equalities(qp: QuadraticProblem, eps: float) -> QuadraticProblem:
    """RelaxEquality semantics (MadNLP, required by the reference's
    condensed path, src/utils.jl:81-82): every equality row lcon == ucon
    becomes the range lcon−ε̂ ≤ Ax ≤ ucon+ε̂ with ε̂ = ε·max(1, |b|)."""
    eq = qp.lcon == qp.ucon
    if not eq.any():
        return qp
    bump = eps * np.maximum(1.0, np.abs(qp.lcon))
    lcon = np.where(eq, qp.lcon - bump, qp.lcon)
    ucon = np.where(eq, qp.ucon + bump, qp.ucon)
    return dataclasses.replace(qp, lcon=lcon, ucon=ucon)


def solve_sparse_condensed(qp: QuadraticProblem, order: str = "auto",
                           eq_relax: Optional[float] = None, **options):
    """Solve a sparse LP/QP fully on device via the condensed (K1) KKT.

    Equality rows are relaxed by ``eq_relax`` (default: the solve
    tolerance) so every row carries a slack — the condensed elimination
    needs Σs on each row.  Returns ExecutionStats like mq.solve.
    """
    from ..solver.sparse_qp import SparseQPProblem, _host_endgame, finish_stats
    from ..utils import load_options

    from .sparse_common import (canonical_coo_vals, get_sparse_kernel,
                                resolve_endgame,
                                pattern_fingerprint, stepped_solve)

    opts, _ = load_options(**options)
    opts = resolve_endgame(opts)
    if eq_relax is None:
        eq_relax = opts.tol
    qp_rel = relax_equalities(qp, float(eq_relax))
    std, info, x0, y0 = build_standard_form_sparse(
        qp_rel, scaling=opts.scaling, max_gradient=opts.max_gradient
    )
    m = std.A.shape[0]
    n0 = std.A.shape[1] - m
    if n0 < 0 or len(info.ineq_rows) != m:
        raise AssertionError("condensed path requires every row slacked")
    fp = pattern_fingerprint(std.A, std.H)
    A0 = std.A[:, :n0].tocsc()
    H0 = None if std.H is None else std.H[:n0, :n0].tocsc()

    def kernel_for(o):
        return get_sparse_kernel(
            f"cond:{order}", fp, o,
            lambda: DeviceSparseCondensedKKT(
                H0, A0, order=order,
                fact_dtype=o.factorization_dtype or None,
                inverse=(o.solve_mode == "inverse"),
                krylov=o.krylov_solve, krylov_tol=o.krylov_tol,
                krylov_maxit=o.krylov_maxit,
                schedule_mode=o.sparse_schedule,
            ),
        )

    two_phase = (opts.factorization_dtype == "float32"
                 and opts.precision_scheme == "two-phase"
                 and opts.tol < opts.phase1_tol)
    if two_phase:
        from .sparse_common import two_phase_opts
        # typed_phase1 stays OFF here: the condensed elimination's
        # D = (Sigma_s^-1 - del_c)^-1 arithmetic breaks down with a
        # fully-f32 state (ERROR_IN_STEP_COMPUTATION on random ineq QPs);
        # the f64-state/f32-factorization scheme is kept instead.
        opts1, opts2 = two_phase_opts(opts)
    else:
        opts1, opts2 = opts, None

    try:
        kkt, kernel, jits = kernel_for(opts1)
    except SC.ScheduleTooLargeError:
        # High-fill pattern: whole solve on the host path (see
        # sparse_chol.ScheduleTooLargeError / sparse_qp fallback).
        from .sparse_qp import _host_full_solve

        return _host_full_solve(qp_rel, opts, time.time())
    Acoo = sp.csc_matrix(std.A)
    Acoo.sum_duplicates()
    Acoo = Acoo.sorted_indices().tocoo()

    def make_arrays(dt):
        """Problem pytree + bounds + starting point at dtype dt (phase 1
        may run fully in f32 — options.phase1_dtype; the endgame needs
        the f64 twin)."""
        # Assembled as NUMPY, shipped with ONE device_put instead of a
        # transfer per array.
        dt = np.dtype(str(jnp.dtype(dt)))
        if std.H is not None and std.H.nnz:
            from .sparse_common import canonical_csc

            Hcoo = canonical_csc(std.H).tocoo()
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
            a_rows=Acoo.row.astype(np.int32),
            a_cols=Acoo.col.astype(np.int32),
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
    host_endgame = two_phase and opts.endgame == "host"
    with jax.default_matmul_precision("highest"):
        finish2 = None
        if two_phase and not host_endgame:
            # Overlap the endgame compile with phase 1 (see sparse_lp).
            from .sparse_common import start_phase2_overlap

            prob2, lb2, ub2, x02, y02 = make_arrays(opts2.dtype)
            ones_n = jnp.ones_like(x02)
            finish2 = start_phase2_overlap(
                kernel_for, opts2,
                (prob2, x02, y02, ones_n, ones_n, lb2, ub2))
        final = jax.block_until_ready(
            jits["solve"](prob, x0j, y0j, lb, ub)
        )
        extra = 0
        ls_time = None
        if opts.measure_linear_solver:
            from .sparse_common import measure_sparse_ls

            ls_time = measure_sparse_ls(kkt, prob, final, lb, ub)
        if host_endgame:
            # Coordinates must match: hand the RELAXED problem (the same
            # one this std was built from) to the host solver.
            stats = _host_endgame(qp_rel, opts, final, info, std, t0,
                                  kkt_system="k2")
            if ls_time is not None:
                stats.counters.linear_solver_time += ls_time
            return stats
        eg_time = 0.0
        eg_backend = ""
        if two_phase:
            eg_t0 = time.time()
            eg_backend = "device-f64"
            extra = int(final.k)
            dt2 = jnp.dtype(opts2.dtype)
            final = jax.block_until_ready(
                finish2(prob2, final.x.astype(dt2), final.y.astype(dt2),
                        final.zl.astype(dt2), final.zu.astype(dt2),
                        lb2, ub2)
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
