"""Fully on-device sparse LP path: COO matvecs + supernodal normal equations.

Completes the reference's NormalKKTSystem story on device (SURVEY §2.3 #4 and
§7.3 hard part #1): the LP's Jacobian stays sparse on device (COO +
segment-sum matvecs), the normal matrix S = A D A' is assembled on device
from host-precomputed contribution index lists (the jittable equivalent of
the reference's assemble_normal_system!, src/utils.jl:266-298), and the
factorization is the supernodal multifrontal Cholesky (ops/sparse_chol).

Everything shape-dependent happens once at construction (the reference's
build-once/refactor-every-iteration split); the per-iteration work is pure
gather/segment-sum/dense-front compute.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops import sparse_chol as SC


class SparseLPProblem(NamedTuple):
    """LP problem data with a device-resident COO Jacobian.

    Satisfies the same protocol as ProblemArrays (MPCKernel plugs in
    unchanged); `H` is absent — LP only.
    """

    c0: jax.Array
    c: jax.Array
    b: jax.Array
    has_lb: jax.Array
    has_ub: jax.Array
    a_rows: jax.Array   # (nnz,) int32
    a_cols: jax.Array   # (nnz,) int32
    a_vals: jax.Array   # (nnz,)
    # Device-resident symbolic index bundle (assembly pairs + supernodal
    # schedule), injected by the jit wrappers so the index arrays are jit
    # ARGUMENTS, not multi-MB module constants (see sparse_common /
    # ops/sparse_chol pytree registration).  None => the KKT falls back to
    # its host (numpy-constant) arrays.
    idx: Optional[dict] = None

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def is_lp(self) -> bool:
        return True

    @property
    def H(self):  # for the NormalKKT LP check
        return None

    def hess_mv(self, x):
        return jnp.zeros_like(x)

    def jac_mv(self, x):
        return jax.ops.segment_sum(
            self.a_vals * x[self.a_cols], self.a_rows, num_segments=self.m
        )

    def jac_rmv(self, y):
        return jax.ops.segment_sum(
            self.a_vals * y[self.a_rows], self.a_cols, num_segments=self.n
        )


class DeviceSparseNormalKKT:
    """Normal-equations KKT with on-device sparse assembly + supernodal
    Cholesky.

    Goes beyond the reference's NormalKKTSystem (LP only,
    normalkkt.jl:45-48): separable QPs — diagonal Hessian — keep
    W = H + Σ diagonal, so the same SPD reduction
    S = A W⁻¹ Aᵀ − δ_c I applies; the diagonal Hessian rides in through
    the traced problem arrays (`prob.h_vals` with h_rows == h_cols).
    Non-diagonal Hessians must use DeviceSparseAugmentedKKT."""

    name = "sparse-normal(device)"

    def __init__(self, A: sp.spmatrix, order: str = "auto",
                 max_supernode: int = 128, mode: str = "batched",
                 fact_dtype=None, inverse: bool = False,
                 krylov: bool = False, krylov_tol: float = 1e-12,
                 krylov_maxit: int = 64, schedule_mode: str = "greedy"):
        self.fact_dtype = jnp.dtype(fact_dtype) if fact_dtype else None
        self.inverse = inverse
        # krylov: keep the (f32) factorization as a PRECONDITIONER and
        # solve the SPD scaled normal system with f64 conjugate gradients
        # (ops/krylov.pcg) — the two-phase endgame without an f64
        # factorization (options.endgame="krylov").
        self.krylov = krylov
        self.krylov_tol = float(krylov_tol)
        self.krylov_maxit = int(krylov_maxit)
        A = sp.csc_matrix(A)
        A.sum_duplicates()
        A = A.sorted_indices()
        m, n = A.shape
        self.m, self.n = m, n
        # Canonical nonzero ordering: the pair_p/pair_q contribution indices
        # below address A's CSC data array.  Callers MUST build the problem's
        # (a_rows, a_cols, a_vals) from these three arrays so the orderings
        # agree (std.A is CSR — its COO data order is row-major, not CSC).
        Acoo = A.tocoo()
        self.coo_rows = Acoo.row.astype(np.int32)
        self.coo_cols = Acoo.col.astype(np.int32)
        self.coo_vals = Acoo.data.copy()

        # Assembly-route guard: the pair contribution lists below cost
        # sum_k nnz(col_k)^2 host work AND memory — an A with dense
        # columns (e.g. the svm family: 200 columns x 3000 rows) explodes
        # them to ~1e9 entries (symbolic analysis of the svm family never
        # finished because of exactly this).  In dense mode with pair
        # blow-up, assemble S = A D A' per iteration as a dense on-device
        # matmul instead (scatter a_vals into a dense (m, n), one GEMM)
        # and skip the symbolic machinery entirely.
        col_nnz = np.diff(A.indptr)
        npairs = int(np.sum(col_nnz.astype(np.int64) ** 2 + col_nnz) // 2)
        self.assembly = "pairs"
        self.mode = mode
        # Matmul assembly beats the pair-gather route well before the
        # pair lists explode: one dense (m x n) GEMM replaces millions of
        # gathers (thresholds set on earlier hardware; they await a
        # sweep).  Route to matmul whenever the dense Jacobian is
        # affordable AND the gather count dwarfs it (or the pair lists
        # are outright explosive, the original svm guard).
        if mode == "dense" and m * n <= int(2e8) and (
                npairs > int(2e7) or npairs > 4 * m * n):
            self.assembly = "matmul"
            self.symb = None
            self.value_gather = None
            self.use_ldl = False
            self._device_idx = None
            return

        # Pattern of S = A A' (+ explicit diagonal for the -del_c term).
        Abool = A.copy()
        Abool.data = np.ones_like(Abool.data)
        S_pat = (Abool @ Abool.T + sp.eye(m)).tocsc().sorted_indices()

        # Contribution lists: for column k of A with rows R_k, every pair
        # (i, j) in R_k x R_k with i >= j contributes A_ik D_k A_jk to S_ij
        # (lower triangle; the factorization consumes upper-CSC == lower-CSR).
        Acsc = A
        indptr, indices = Acsc.indptr, Acsc.indices
        # value-position lookup in the UPPER-CSC of S (what analyze stores)
        S_up = sp.triu(S_pat.tocsr(), k=0, format="csc").sorted_indices()
        pos = {}
        for j in range(m):
            for p in range(S_up.indptr[j], S_up.indptr[j + 1]):
                i = int(S_up.indices[p])  # i <= j: upper entry (i, j)
                pos[(i, j)] = p
        pair_p, pair_q, pair_k, pair_e = [], [], [], []
        for k in range(n):
            lo, hi = indptr[k], indptr[k + 1]
            rows = indices[lo:hi]
            for a in range(lo, hi):
                ia = int(indices[a])
                for bq in range(lo, hi):
                    jb = int(indices[bq])
                    if jb > ia:
                        continue  # keep i >= j (lower); upper key is (j, i)
                    pair_p.append(a)
                    pair_q.append(bq)
                    pair_k.append(k)
                    pair_e.append(pos[(jb, ia)])
        # NOTE: all symbolic index arrays stay NUMPY (host constants folded
        # at compile); device_idx() ships the large ones as jit arguments.
        self.pair_p = np.asarray(pair_p, np.int32)
        self.pair_q = np.asarray(pair_q, np.int32)
        self.pair_k = np.asarray(pair_k, np.int32)
        self.pair_e = np.asarray(pair_e, np.int32)
        self.nnz_up = int(S_up.nnz)
        # diagonal positions in the upper-CSC value array (for -del_c I)
        diag_pos = np.asarray([pos[(j, j)] for j in range(m)], np.int32)
        self.diag_pos = diag_pos
        # (row, col) of every upper-CSC entry, for symmetric Jacobi scaling
        # (the reference's K2.5 ScaledSparseKKTSystem idea applied to the
        # normal equations: unit diagonal tames the barrier's 1e+-8 range,
        # which f32 factorization needs at scale).
        self.entry_row = S_up.indices.astype(np.int32)
        self.entry_col = np.repeat(
            np.arange(m, dtype=np.int32), np.diff(S_up.indptr)
        )

        # Supernodal symbolic over the S pattern; we feed values directly in
        # the symbolic's permuted upper-CSC order via a static gather.
        # mode="batched" uses the level-scheduled shape-bucketed numeric
        # phase (SPARSE_PLAN S3): compile cost O(levels x buckets) instead of
        # O(supernodes), and every bucket is one batched dense front.
        self.mode = mode
        if mode == "dense":
            # Dense-normal regime (small m): scatter the assembled upper
            # entries into ONE (m, m) matrix and factor it with the
            # GEMM-rich dense inverse-factor Cholesky
            # (ops/blocked_dense.factor_inv_chol) — backsolves become two
            # matvecs.  At small m the supernodal scan's hundreds of small
            # bucket ops are latency-bound; one dense factorization suits
            # this shape.  The reference reaches the same regime through
            # cuDSS's internal dense-front switch.
            self.symb = None
            self.value_gather = None
            self.use_ldl = False
            self._device_idx = None
            return
        if mode == "batched":
            self.symb = SC.analyze_batched(
                S_pat, order=order, max_supernode=max_supernode,
                schedule_mode=schedule_mode,
            )
        else:
            self.symb = SC.analyze(S_pat, order=order,
                                   max_supernode=max_supernode)
        # map: permuted-upper-CSC position -> original-upper-CSC position
        perm = self.symb.perm
        # entry (Ui[p], j) of permuted upper = original (perm[Ui[p]], perm[j])
        gmap = np.empty(len(self.symb.Ui), np.int32)
        Up, Ui = self.symb.Up, self.symb.Ui
        for j in range(m):
            gj = int(perm[j])
            for p in range(Up[j], Up[j + 1]):
                gi = int(perm[int(Ui[p])])
                a, bb = (gi, gj) if gi <= gj else (gj, gi)
                gmap[p] = pos[(a, bb)]
        self.value_gather = gmap

        # f32 factorization of the (SPD but cond~1e8 near convergence)
        # normal matrix breaks plain Cholesky from n≈4000: roundoff drives
        # trailing pivots negative and the 3x100x regularization retries
        # can't save it.  Route f32 through the pivot-floored LDL kernels
        # (signs all +1) — the same cuDSS-style static pivoting the
        # augmented path uses; iterative refinement absorbs the
        # perturbation (reference hook: src/linear_solver.jl:28-43).
        self.use_ldl = (self.fact_dtype == jnp.float32
                        and mode == "batched")
        if self.use_ldl:
            self.expected_signs = SC.bucket_signs(self.symb, np.ones(m))
            self.pivot_floor = 1e-6
        self._device_idx = None

    def host_idx(self) -> dict:
        """Index bundle in host (numpy) form — folded as constants when a
        problem carries no device bundle."""
        if self.assembly == "matmul":
            return dict()
        d = dict(
            pair_p=self.pair_p, pair_q=self.pair_q,
            pair_k=self.pair_k, pair_e=self.pair_e,
            diag_pos=self.diag_pos, entry_row=self.entry_row,
            entry_col=self.entry_col,
        )
        if self.mode != "dense":
            d["sym"] = self.symb
            d["value_gather"] = self.value_gather
        return d

    def device_idx(self) -> Optional[dict]:
        """Device-resident twin of host_idx(), built once; pass as a jit
        argument (prob.idx) to keep index arrays out of the module.  Only
        the batched mode's schedule is pytree-registered."""
        if self.mode not in ("batched", "dense"):
            return None
        if self._device_idx is None:
            self._device_idx = jax.device_put(self.host_idx())
        return self._device_idx

    def factorize(self, prob: SparseLPProblem, pr_diag, del_c):
        ix = prob.idx if getattr(prob, "idx", None) is not None \
            else self.host_idx()
        # W = Σ (+ diag(H) for separable QPs): stays diagonal, so the
        # normal-equations reduction is exact.  h_vals arrives through the
        # traced problem arrays (zero-length for an LP — a static shape).
        h_vals = getattr(prob, "h_vals", None)
        if h_vals is not None and h_vals.shape[0]:
            pr_diag = pr_diag + jax.ops.segment_sum(
                h_vals, prob.h_rows, num_segments=self.n
            )
        D = 1.0 / pr_diag
        if self.assembly == "matmul":
            return self._factorize_matmul(prob, D, del_c)
        contrib = (
            prob.a_vals[ix["pair_p"]]
            * D[ix["pair_k"]]
            * prob.a_vals[ix["pair_q"]]
        )
        s_vals = jax.ops.segment_sum(
            contrib, ix["pair_e"], num_segments=self.nnz_up
        )
        s_vals = s_vals.at[ix["diag_pos"]].add(-del_c)
        # Symmetric Jacobi scaling to unit diagonal (K2.5 analog): Ms =
        # Ds S Ds, solve via S^-1 = Ds Ms^-1 Ds.  Keeps f32 factorization
        # usable when the barrier diagonal spans ~1e+-8.
        s_diag = s_vals[ix["diag_pos"]]
        scale = jax.lax.rsqrt(jnp.maximum(s_diag, jnp.finfo(s_diag.dtype).tiny))
        s_vals = s_vals * scale[ix["entry_row"]] * scale[ix["entry_col"]]
        if self.mode == "dense":
            if self.fact_dtype is not None and s_vals.dtype != self.fact_dtype:
                s_vals = s_vals.astype(self.fact_dtype)
            from ..ops.blocked_dense import factor_inv_chol

            m = self.m
            Su = jnp.zeros((m, m), s_vals.dtype)
            Su = Su.at[ix["entry_row"], ix["entry_col"]].set(s_vals)
            Sd = Su + Su.T - jnp.diag(jnp.diagonal(Su))
            if self.fact_dtype == jnp.float32:
                # f32 needs cuDSS-style static pivoting: plain Cholesky
                # of the (cond~1e8 near convergence) normal matrix goes
                # negative in the trailing pivots on degenerate LPs and
                # the retry escalation can't save it (measured: transport
                # xlarge burned 80 capped f32 iterations).  On the
                # Jacobi-scaled (unit-diagonal) matrix a 1e-6 diagonal
                # SHIFT bounds the pivots exactly like the old per-pivot
                # LDL floor — but keeps the faster XLA-panel Cholesky
                # path.  The shift is below the f32 factorization's own ~1e-5
                # roundoff and is absorbed by iterative refinement, same
                # as the floor was.
                Sd = Sd + jnp.asarray(1e-6, Sd.dtype) * jnp.eye(
                    m, dtype=Sd.dtype)
            Lc, iL = factor_inv_chol(Sd)
            return ((Lc, iL, None), D, scale, prob, del_c)
        s_vals = s_vals[ix["value_gather"]]
        if self.fact_dtype is not None and s_vals.dtype != self.fact_dtype:
            # Mixed precision (see sparse_qp): f32 factorization; the MPC
            # kernel's iterative refinement recovers f64.
            s_vals = s_vals.astype(self.fact_dtype)
        sym = ix["sym"]
        if self.use_ldl:
            panels = SC.factorize_batched_ldl(
                sym, s_vals, signs=self.expected_signs,
                pivot_floor=self.pivot_floor, inverse=self.inverse)
        elif self.mode == "batched":
            panels = SC.factorize_batched(sym, s_vals,
                                          inverse=self.inverse)
        else:
            panels = SC.factorize(sym, s_vals)
        return (panels, D, scale, prob, del_c)

    def _factorize_matmul(self, prob, D, del_c):
        """Dense-mode assembly without pair lists: scatter a_vals into a
        dense (m, n) Jacobian and form S = (A * D) A' as ONE GEMM.
        Used when A has dense columns that explode the pair contribution
        lists (svm: 9e8 pairs); the GEMM is ~2 m^2 n flops for every shape
        this mode admits (m*n <= 2e8)."""
        dt = (self.fact_dtype
              if self.fact_dtype is not None else prob.a_vals.dtype)
        from ..ops.blocked_dense import factor_inv_chol

        m, n = self.m, self.n
        Ad = jnp.zeros((m, n), dt)
        Ad = Ad.at[prob.a_rows, prob.a_cols].set(prob.a_vals.astype(dt))
        Sd = (Ad * D.astype(dt)[None, :]) @ Ad.T
        Sd = Sd - del_c * jnp.eye(m, dtype=dt)
        s_diag = jnp.diagonal(Sd)
        scale = jax.lax.rsqrt(jnp.maximum(s_diag, jnp.finfo(dt).tiny))
        Sd = Sd * scale[:, None] * scale[None, :]
        if self.fact_dtype == jnp.float32:
            # diagonal shift as static pivoting on the unit-scaled matrix
            # (see factorize)
            Sd = Sd + jnp.asarray(1e-6, dt) * jnp.eye(m, dtype=dt)
        Lc, iL = factor_inv_chol(Sd)
        return ((Lc, iL, None), D, scale.astype(D.dtype), prob, del_c)

    def _apply_factor(self, sym, panels, r2):
        """One backsolve against the stored factorization (in its dtype)."""
        out_dtype = r2.dtype
        if self.fact_dtype is not None and r2.dtype != self.fact_dtype:
            r2 = r2.astype(self.fact_dtype)
        if self.mode == "dense":
            _L, iL, dd = panels
            y = iL @ r2
            if dd is not None:          # floored-LDL form (f32)
                y = y / dd
            return (iL.T @ y).astype(out_dtype)
        if self.use_ldl:
            dy = SC.solve_batched_ldl(sym, panels, r2, inverse=self.inverse)
        elif self.mode == "batched":
            dy = SC.solve_batched(sym, panels, r2, inverse=self.inverse)
        else:
            dy = SC.solve(sym, panels, r2)
        return dy.astype(out_dtype)

    def solve(self, factors, rx, ry):
        panels, D, scale, prob, del_c = factors
        ix = prob.idx if getattr(prob, "idx", None) is not None \
            else self.host_idx()
        sym = ix.get("sym")
        r1 = rx * D
        r2 = (prob.jac_mv(r1) - ry) * scale
        if self.krylov:
            # f64 PCG on the scaled SPD normal matrix
            # Ms = Ds (A D A' - del_c I) Ds with the f32 factor as M^-1.
            from ..ops.krylov import pcg

            def matvec(v):
                u = scale * v
                return (scale * prob.jac_mv(D * prob.jac_rmv(u))
                        - del_c * scale * u)

            dy, _k = pcg(matvec, lambda r: self._apply_factor(sym, panels, r),
                         r2, tol_rel=self.krylov_tol,
                         maxit=self.krylov_maxit)
        else:
            dy = self._apply_factor(sym, panels, r2)
        dy = dy * scale
        dx = (rx - prob.jac_rmv(dy)) * D
        return dx, dy

    def factor_ok(self, factors):
        panels, D, _scale, _prob, _dc = factors
        ok = jnp.all(D > 0)
        if self.mode == "dense":
            if panels[2] is not None:   # floored LDL: pivots clamped > 0
                return ok & jnp.all(jnp.isfinite(panels[2]))
            dP = jnp.diagonal(panels[0])
            return ok & jnp.all(jnp.isfinite(dP)) & jnp.all(dP > 0)
        if self.use_ldl:
            return ok & SC.factor_ok_batched_ldl(panels,
                                                 self.expected_signs)
        if self.mode == "batched":
            return ok & SC.factor_ok_batched(panels)
        for P in panels:
            w = min(P.shape)  # diag block is the top w x w
            dP = jnp.diagonal(P[: P.shape[1], :])
            ok = ok & jnp.all(jnp.isfinite(dP)) & jnp.all(dP > 0)
        return ok


def solve_sparse_lp(qp: QuadraticProblem, order: str = "auto",
                    mode: str = "auto", **options):
    """Solve a (large sparse) LP — or separable (diagonal-Hessian) QP —
    fully on device: sparse matvecs + on-device normal-equation assembly +
    supernodal (or, for small m, one dense) Cholesky.

    mode: "auto" routes m <= dense_normal_limit (options, default 12288)
    to the dense-normal factorization — the supernodal scan's many small
    bucket ops are latency-bound at that size — and larger
    systems to the level/greedy supernodal path ("batched").  Pass
    "batched" / "scan" / "dense" to force.

    Returns ExecutionStats like mq.solve.
    """
    import time

    from ..solver.mpc import MPCKernel
    from ..solver.sparse_qp import SparseQPProblem, _host_endgame, finish_stats
    from ..utils import load_options

    from .sparse_common import (canonical_coo_vals, get_sparse_kernel,
                                resolve_endgame,
                                pattern_fingerprint, stepped_solve)

    opts, _ = load_options(**options)
    opts = resolve_endgame(opts)
    std, info, x0, y0 = build_standard_form_sparse(
        qp, scaling=opts.scaling, max_gradient=opts.max_gradient
    )
    if std.H is not None and std.H.nnz:
        Hcoo = sp.coo_matrix(std.H)
        if not (Hcoo.row == Hcoo.col).all():
            raise ValueError(
                "solve_sparse_lp handles LPs and diagonal-Hessian QPs only "
                "(use solve_sparse_qp for general sparse QPs)."
            )
    if mode == "auto":
        mode = "dense" if std.A.shape[0] <= opts.dense_normal_limit \
            else "batched"
    fp = pattern_fingerprint(std.A, std.H)

    def kernel_for(o):
        # Pattern-keyed kernel reuse: same sparsity + options => no
        # symbolic re-analysis and no retrace (values are traced args).
        return get_sparse_kernel(
            f"lp:{order}:{mode}", fp, o,
            lambda: DeviceSparseNormalKKT(
                std.A, order=order, mode=mode,
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
        opts1, opts2 = two_phase_opts(opts, typed_phase1=True)
    else:
        opts1, opts2 = opts, None

    try:
        kkt, kernel, jits = kernel_for(opts1)
    except SC.ScheduleTooLargeError:
        # High-fill pattern: the flat scatter-map schedule would exceed
        # the update-traffic cap — run the whole solve on the host path
        # instead of OOM-killing the process (see
        # sparse_chol.ScheduleTooLargeError).
        from ..solver.sparse_qp import _host_full_solve

        return _host_full_solve(qp, opts, time.time(),
                                kkt_system="normal")

    def make_arrays(dt):
        """Problem pytree + bounds + starting point at dtype dt (phase 1
        may run fully in f32 — options.phase1_dtype — while the endgame
        needs the f64 twin).  Assembled as NUMPY and shipped with ONE
        device_put instead of one transfer per array."""
        dt = np.dtype(str(jnp.dtype(dt)))
        base = dict(
            c0=np.asarray(std.c0, dt),
            c=np.asarray(std.c, dt),
            b=np.asarray(std.b, dt),
            has_lb=np.asarray(std.has_lb),
            has_ub=np.asarray(std.has_ub),
            a_rows=np.asarray(kkt.coo_rows),
            a_cols=np.asarray(kkt.coo_cols),
            a_vals=canonical_coo_vals(std.A).astype(dt),
        )
        if std.H is not None and std.H.nnz:
            from .sparse_common import canonical_csc

            Hcoo = canonical_csc(std.H).tocoo()
            p = SparseQPProblem(
                **base,
                h_rows=Hcoo.row.astype(np.int32),
                h_cols=Hcoo.col.astype(np.int32),
                h_vals=canonical_coo_vals(std.H).astype(dt),
            )
        else:
            p = SparseLPProblem(**base)
        return jax.device_put(
            (p, np.asarray(std.lb, dt), np.asarray(std.ub, dt),
             np.asarray(x0, dt), np.asarray(y0, dt)))

    prob, lb, ub, x0j, y0j = make_arrays(opts1.dtype)
    t0 = time.time()
    # f32 matmuls at default precision may run in TF32 on tensor-core GPUs
    # — fatal for an f32 factorization.  Force full-f32 products while
    # tracing the solve (MPCKernel pins its own traces too; this also
    # covers the measurement jits below).
    host_endgame = two_phase and opts.endgame == "host"
    # Loop style under loop_mode='auto': ALL device paths dispatch
    # bounded chunks of iterations (chunked_solve — ~1/chunk of the
    # stepped loop's per-iteration host syncs, with every dispatch's wall
    # bounded).  The chunk lengths were set on earlier hardware; whether
    # the GPU needs chunking at all is an open measurement.
    if opts.loop_mode == "python":
        style = "stepped"
    elif opts.loop_mode == "jit":
        style = "jit"
    else:
        style = "chunked"
    stepped = style in ("stepped", "chunked")
    if style == "chunked":
        from .sparse_common import chunked_solve, dense_chunk_len

        if mode == "dense":
            chunk1 = dense_chunk_len(std.A.shape[0])
            # f64 endgame iterations are slower
            chunk2 = dense_chunk_len(std.A.shape[0], target_flops=2e10)
        else:
            # supernodal: per-iteration device wall is sparse-fill bound
            # — a fixed chunk of 8 keeps each dispatch bounded while
            # amortizing dispatch cost
            chunk1, chunk2 = 8, 4
    with jax.default_matmul_precision("highest"):
        finish2 = None
        if two_phase and not host_endgame and not stepped:
            # Compile the endgame on a background thread while phase 1
            # traces/compiles/runs (sparse_common.start_phase2_overlap).
            from .sparse_common import start_phase2_overlap

            prob2, lb2, ub2, x02, y02 = make_arrays(opts2.dtype)
            ones_n = jnp.ones_like(x02)
            finish2 = start_phase2_overlap(
                kernel_for, opts2,
                (prob2, x02, y02, ones_n, ones_n, lb2, ub2))
        if style == "chunked":
            final = chunked_solve(jits, prob, x0j, y0j, lb, ub, chunk=chunk1)
        elif style == "stepped":
            final = stepped_solve(jits, prob, x0j, y0j, lb, ub)
        else:
            final = jax.block_until_ready(
                jits["solve"](prob, x0j, y0j, lb, ub)
            )
        extra = 0
        # linear_solver_time (reference scripts/benchmarks_cpu.jl:55):
        # opt-in post-solve measurement per phase (measure_sparse_ls) —
        # inside a jitted dispatch per-iteration timing is unobservable.
        ls_time = None
        if opts.measure_linear_solver:
            from .sparse_common import measure_sparse_ls

            ls_time = measure_sparse_ls(kkt, prob, final, lb, ub)
        if host_endgame:
            # Endgame on the HOST C++ LDL path, warm-started from the f32
            # iterate: the f64 XLA program (a second large compile) never
            # compiles.  Dense-column patterns (matmul assembly) make
            # S = A D A' dense: the host's sparse up-looking LDL pays the
            # full O(m^3) inside a CSC data structure (~12 s per
            # factorization on svm m=3000), so those hand over to the host
            # K2 augmented system instead, whose fill tracks nnz(A).
            eg_kkt = "k2" if kkt.assembly == "matmul" else "normal"
            stats = _host_endgame(qp, opts, final, info, std, t0,
                                  kkt_system=eg_kkt)
            if ls_time is not None:
                # total = measured device phase 1 + the host endgame's own
                # accumulated factorize+solve time
                stats.counters.linear_solver_time += ls_time
            return stats
        eg_time = 0.0
        eg_backend = ""
        if two_phase:
            # Endgame warm-started from the f32 phase's iterate: f32
            # factors of a cond>1e7 KKT stall short of 1e-8 under
            # stationary refinement, so the endgame runs either the f64
            # refactorization or f64 PCG preconditioned by the f32 factor
            # (options.endgame="krylov").
            eg_t0 = time.time()
            eg_backend = "device-" + (opts.endgame or "f64")
            extra = int(final.k)
            dt2 = jnp.dtype(opts2.dtype)
            wx, wy = final.x.astype(dt2), final.y.astype(dt2)
            wzl, wzu = final.zl.astype(dt2), final.zu.astype(dt2)
            if stepped:
                prob2, lb2, ub2, _, _ = make_arrays(opts2.dtype)
                _, _, jits2 = kernel_for(opts2)
                if style == "chunked":
                    final = chunked_solve(jits2, prob2, wx, wy, lb2, ub2,
                                          warm=(wzl, wzu), chunk=chunk2)
                else:
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
