"""Problem containers: user-facing general QP and internal standard form.

User-facing container mirrors QuadraticModels.QuadraticModel as consumed by
the reference (/root/reference/test/runtests.jl:39-55, scripts/common.jl:133):

    min_x  c0 + c'x + 1/2 x'Hx   s.t.  lcon <= Ax <= ucon,  lvar <= x <= uvar

The internal `StandardQP` is the device data model replacing MadNLP's
PrimalVector/SubVector index-view machinery (SURVEY §1 L2): slack variables
are appended so every constraint is an equality `A x = b`, and bound index
sets (`ind_lb`/`ind_ub` in the reference, src/structure.jl:95-102) become
boolean masks over full-length padded arrays — accelerators prefer masked
dense math over gathers.  Fixed variables (lvar == uvar) are eliminated by substitution,
the functional equivalent of MadNLP's MakeParameter treatment.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp


# ---------------------------------------------------------------------------
# User-facing container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuadraticProblem:
    """General-form convex QP (QuadraticModels.QuadraticModel analog).

    H and A are scipy CSR matrices; H is the *full* symmetric Hessian.
    """

    c: np.ndarray
    A: sp.csr_matrix
    lcon: np.ndarray
    ucon: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray
    H: Optional[sp.csr_matrix] = None
    c0: float = 0.0
    x0: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    minimize: bool = True
    name: str = "qp"

    def __post_init__(self):
        self.c = np.asarray(self.c, dtype=np.float64).ravel()
        n = self.c.shape[0]
        if self.A is None:
            self.A = sp.csr_matrix((0, n))
        if not sp.issparse(self.A):
            self.A = sp.csr_matrix(np.asarray(self.A, dtype=np.float64))
        else:
            self.A = self.A.tocsr().astype(np.float64)
        if self.H is not None and not sp.issparse(self.H):
            self.H = sp.csr_matrix(np.asarray(self.H, dtype=np.float64))
        elif self.H is not None:
            self.H = self.H.tocsr().astype(np.float64)
        if self.H is not None and self.H.nnz == 0:
            self.H = None
        m = self.A.shape[0]
        self.lcon = _as_vec(self.lcon, m)
        self.ucon = _as_vec(self.ucon, m)
        self.lvar = _as_vec(self.lvar, n, default=-np.inf)
        self.uvar = _as_vec(self.uvar, n, default=np.inf)
        self.x0 = _as_vec(self.x0, n, default=0.0)
        self.y0 = _as_vec(self.y0, m, default=0.0)

    # -- dimensions (NLPModels meta analog) --------------------------------

    @property
    def nvar(self) -> int:
        return self.c.shape[0]

    @property
    def ncon(self) -> int:
        return self.A.shape[0]

    @property
    def nnzj(self) -> int:
        return self.A.nnz

    @property
    def nnzh(self) -> int:
        return 0 if self.H is None else self.H.nnz

    @property
    def is_lp(self) -> bool:
        return self.H is None

    # -- evaluation (model-callback layer; reference SURVEY §1 L3) ---------

    def obj(self, x: np.ndarray) -> float:
        """Objective value f(x) (sense-free: the solver minimizes -f when
        `minimize` is False; this always evaluates f itself)."""
        val = self.c0 + float(self.c @ x)
        if self.H is not None:
            val += 0.5 * float(x @ (self.H @ x))
        return val

    def grad(self, x: np.ndarray) -> np.ndarray:
        g = self.c.copy()
        if self.H is not None:
            g += self.H @ x
        return g

    def cons(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self.A @ x).ravel()

    def jtprod(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(self.A.T @ y).ravel()


def _as_vec(v, size, default=0.0):
    if v is None:
        return np.full(size, default, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64).ravel()
    assert v.shape[0] == size, f"expected size {size}, got {v.shape[0]}"
    return v


def from_coo(
    c,
    Hrows=None,
    Hcols=None,
    Hvals=None,
    Arows=None,
    Acols=None,
    Avals=None,
    lcon=None,
    ucon=None,
    lvar=None,
    uvar=None,
    c0=0.0,
    x0=None,
    y0=None,
    ncon=None,
    minimize=True,
    name="qp",
) -> QuadraticProblem:
    """Build from lower-triangular COO Hessian + COO Jacobian.

    Matches the QuadraticModels COO convention used by the reference tests
    (test/runtests.jl:24-55): H given as its lower triangle, symmetrized here.
    """
    c = np.asarray(c, dtype=np.float64).ravel()
    n = c.shape[0]
    if ncon is None:
        ncon = len(lcon) if lcon is not None else 0
    if Arows is not None and len(Arows) > 0:
        A = sp.coo_matrix(
            (np.asarray(Avals, dtype=np.float64),
             (np.asarray(Arows, dtype=np.int64), np.asarray(Acols, dtype=np.int64))),
            shape=(ncon, n),
        ).tocsr()
    else:
        A = sp.csr_matrix((ncon, n))
    H = None
    if Hrows is not None and len(Hrows) > 0:
        L = sp.coo_matrix(
            (np.asarray(Hvals, dtype=np.float64),
             (np.asarray(Hrows, dtype=np.int64), np.asarray(Hcols, dtype=np.int64))),
            shape=(n, n),
        ).tocsr()
        D = sp.diags(L.diagonal())
        H = (L + L.T - D).tocsr()
    return QuadraticProblem(
        c=c, A=A, H=H, c0=c0, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar,
        x0=x0, y0=y0, minimize=minimize, name=name,
    )


# ---------------------------------------------------------------------------
# Internal standard form
# ---------------------------------------------------------------------------


class StandardQP(NamedTuple):
    """Internal standard form as a pytree of (host numpy) arrays:

        min c0 + c'x + 1/2 x'Hx   s.t.  A x = b,   lb <= x <= ub (masked)

    where x already contains the inequality slacks.  `lb`/`ub` are sanitized
    (finite placeholder where the mask is False) so that masked arithmetic
    never produces 0 * inf = nan (SURVEY §7.3 hard part 5).
    """

    c0: np.ndarray          # scalar
    c: np.ndarray           # (n,)
    H: Optional[np.ndarray]  # (n, n) dense or None for LP
    A: np.ndarray           # (m, n) dense
    b: np.ndarray           # (m,)
    lb: np.ndarray          # (n,) sanitized: 0 where has_lb is False
    ub: np.ndarray          # (n,)
    has_lb: np.ndarray      # (n,) bool
    has_ub: np.ndarray      # (n,) bool

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def is_lp(self) -> bool:
        return self.H is None


@dataclasses.dataclass
class TransformInfo:
    """Host-side metadata to map internal solutions back to user space."""

    nvar: int               # user variable count
    ncon: int               # user constraint count
    n: int                  # internal variable count (kept vars + slacks)
    m: int                  # internal constraint count (== ncon)
    keep_idx: np.ndarray    # user indices of kept (non-fixed) variables
    fixed_idx: np.ndarray
    fixed_vals: np.ndarray
    n_kept: int
    con_scale: np.ndarray   # (ncon,) row scaling applied to A, b, slack bnds
    obj_scale: float
    minimize: bool
    ineq_rows: np.ndarray   # rows that received a slack variable

    def recover_x(self, x_int: np.ndarray) -> np.ndarray:
        x = np.empty(self.nvar, dtype=np.float64)
        x[self.keep_idx] = x_int[: self.n_kept]
        x[self.fixed_idx] = self.fixed_vals
        return x

    def recover_y(self, y_int: np.ndarray) -> np.ndarray:
        sign = 1.0 if self.minimize else -1.0
        return sign * y_int * self.con_scale / self.obj_scale

    def recover_z(self, z_int: np.ndarray, fill: np.ndarray) -> np.ndarray:
        """Map internal bound multipliers back; `fill` supplies fixed-var entries."""
        sign = 1.0 if self.minimize else -1.0
        z = np.empty(self.nvar, dtype=np.float64)
        z[self.keep_idx] = sign * z_int[: self.n_kept] / self.obj_scale
        z[self.fixed_idx] = fill[self.fixed_idx] if len(self.fixed_idx) else 0.0
        return z


@dataclasses.dataclass
class SparseStandardQP:
    """Internal standard form with scipy-sparse H/A (host sparse path)."""

    c0: float
    c: np.ndarray
    H: Optional[sp.csc_matrix]   # full symmetric, or None for LP
    A: sp.csr_matrix
    b: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    has_lb: np.ndarray
    has_ub: np.ndarray

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def is_lp(self) -> bool:
        return self.H is None

    def densify(self) -> StandardQP:
        return StandardQP(
            c0=np.float64(self.c0),
            c=self.c,
            H=None if self.H is None else self.H.toarray(),
            A=self.A.toarray(),
            b=self.b,
            lb=self.lb,
            ub=self.ub,
            has_lb=self.has_lb,
            has_ub=self.has_ub,
        )


def build_standard_form_sparse(
    qp: QuadraticProblem,
    scaling: bool = True,
    max_gradient: float = 100.0,
    fixed_variable_treatment: str = "make_parameter",
    bound_relax_factor: float = 1e-8,
) -> tuple[SparseStandardQP, TransformInfo, np.ndarray, np.ndarray]:
    """Convert a general QP to internal standard form, keeping H/A sparse.

    Pipeline (reference analogs):
      1. treat fixed variables: eliminate by substitution (MakeParameter
         semantics, src/utils.jl:81) or relax the bound pair in place
         (RelaxBound semantics — the reference's condensed-KKT default);
      2. append one slack per inequality row: `A x - s = 0`, bounds on s
         (MadNLP get_index_constraints semantics, src/structure.jl:95-112);
      3. max-gradient scaling of constraint rows and the objective
         (MadNLP set_scaling! with max_gradient=100, src/solver.jl:148-159).

    Raises NotEnoughDegreesOfFreedomException when the internal equality
    system is over-determined (m > n_free after fixed-variable
    elimination) — the reference surfaces this as status 7
    (src/solver.jl:379-380).

    Returns (standard_qp, info, x0_int, y0_int) with x0/y0 mapped into the
    internal space (slack part initialized to scaled A x0).
    """
    n_user, m_user = qp.nvar, qp.ncon
    lvar, uvar = qp.lvar, qp.uvar
    if np.any(lvar > uvar):
        raise ValueError("infeasible bounds: lvar > uvar")
    if np.any(qp.lcon > qp.ucon):
        raise ValueError("infeasible constraints: lcon > ucon")

    sign = 1.0 if qp.minimize else -1.0

    if fixed_variable_treatment == "relax_bound":
        # RelaxBound (src/utils.jl:81): keep fixed columns as ordinary
        # bounded variables with the pair widened symmetrically; the
        # interior of [l-eps, u+eps] is then non-empty.
        fmask = lvar == uvar
        if np.any(fmask):
            lvar, uvar = lvar.copy(), uvar.copy()
            eps = bound_relax_factor * np.maximum(1.0, np.abs(lvar[fmask]))
            lvar[fmask] -= eps
            uvar[fmask] += eps
    elif fixed_variable_treatment != "make_parameter":
        raise ValueError(
            "fixed_variable_treatment must be 'make_parameter' or "
            f"'relax_bound', got {fixed_variable_treatment!r}"
        )

    fixed_mask = lvar == uvar
    fixed_idx = np.where(fixed_mask)[0]
    keep_idx = np.where(~fixed_mask)[0]
    fixed_vals = lvar[fixed_idx]
    n_kept = keep_idx.shape[0]

    A_full = qp.A.tocsc()
    H_full = None if qp.H is None else (sign * qp.H).tocsc()

    # Fixed-variable elimination by substitution: constraint rows get
    # b -= A[:, fixed] @ x_fixed; objective picks up the cross terms.
    shift = np.zeros(m_user)
    c = sign * qp.c.copy()
    c0 = sign * qp.c0
    if len(fixed_idx) > 0:
        shift = np.asarray(A_full[:, fixed_idx] @ fixed_vals).ravel()
        if H_full is not None:
            Hff = H_full[fixed_idx][:, fixed_idx]
            c0 = c0 + float(c[fixed_idx] @ fixed_vals) + 0.5 * float(
                fixed_vals @ (Hff @ fixed_vals)
            )
            c_kept = c[keep_idx] + np.asarray(
                H_full[keep_idx][:, fixed_idx] @ fixed_vals
            ).ravel()
            H_kept = H_full[keep_idx][:, keep_idx].tocsc()
        else:
            c0 = c0 + float(c[fixed_idx] @ fixed_vals)
            c_kept = c[keep_idx]
            H_kept = None
        A_kept = A_full[:, keep_idx].tocsr()
    else:
        c_kept = c
        H_kept = H_full
        A_kept = qp.A.tocsr()

    lcon = qp.lcon - shift
    ucon = qp.ucon - shift

    # Classify constraint rows.
    eq_rows = np.where(lcon == ucon)[0]
    ineq_rows = np.where(lcon < ucon)[0]
    ns = len(ineq_rows)
    n_int = n_kept + ns
    m_int = m_user
    if m_int > n_int:
        # More equality rows than free columns (inequalities contribute a
        # slack each): the internal equality system is over-determined.
        # The reference maps MadNLP's NotEnoughDegreesOfFreedomException
        # to status 7 (src/solver.jl:379-380).
        from ..utils.exceptions import NotEnoughDegreesOfFreedomException

        raise NotEnoughDegreesOfFreedomException(
            f"{m_int} constraints > {n_int} free variables "
            f"({len(fixed_idx)} fixed eliminated, {ns} slacks added)"
        )

    # Slack block: -I on the inequality rows.
    slack_block = sp.coo_matrix(
        (-np.ones(ns), (ineq_rows, np.arange(ns))), shape=(m_int, ns)
    )
    b_int = np.zeros(m_int, dtype=np.float64)
    b_int[eq_rows] = lcon[eq_rows]

    # Internal bounds.
    lb_raw = np.concatenate([lvar[keep_idx], lcon[ineq_rows]])
    ub_raw = np.concatenate([uvar[keep_idx], ucon[ineq_rows]])

    # Max-gradient scaling (rows + objective).
    x0_kept = qp.x0[keep_idx]
    if scaling and m_int > 0:
        row_max = np.zeros(m_int)
        Ac = A_kept.tocsr()
        if Ac.nnz:
            absA = abs(Ac)
            row_max = absA.max(axis=1).toarray().ravel()
        con_scale = np.minimum(1.0, max_gradient / np.maximum(row_max, 1e-300))
    else:
        con_scale = np.ones(m_int)
    g0 = c_kept if H_kept is None else c_kept + np.asarray(H_kept @ x0_kept).ravel()
    if scaling:
        gmax = np.max(np.abs(g0), initial=0.0)
        obj_scale = float(min(1.0, max_gradient / max(gmax, 1e-300)))
    else:
        obj_scale = 1.0

    A_scaled = sp.diags(con_scale) @ A_kept
    A_int = sp.hstack([A_scaled, slack_block], format="csr")
    b_int = con_scale * b_int
    # Slack bounds live in the scaled row space.
    lb_raw[n_kept:] = con_scale[ineq_rows] * lb_raw[n_kept:]
    ub_raw[n_kept:] = con_scale[ineq_rows] * ub_raw[n_kept:]

    c_int = np.concatenate([obj_scale * c_kept, np.zeros(ns)])
    c0_int = obj_scale * c0
    H_int = None
    if H_kept is not None:
        H_int = sp.block_diag(
            [obj_scale * H_kept, sp.csc_matrix((ns, ns))], format="csc"
        )

    has_lb = np.isfinite(lb_raw)
    has_ub = np.isfinite(ub_raw)
    lb = np.where(has_lb, lb_raw, 0.0)
    ub = np.where(has_ub, ub_raw, 0.0)

    std = SparseStandardQP(
        c0=float(c0_int),
        c=c_int,
        H=H_int,
        A=A_int,
        b=b_int,
        lb=lb,
        ub=ub,
        has_lb=has_lb,
        has_ub=has_ub,
    )
    info = TransformInfo(
        nvar=n_user,
        ncon=m_user,
        n=n_int,
        m=m_int,
        keep_idx=keep_idx,
        fixed_idx=fixed_idx,
        fixed_vals=fixed_vals,
        n_kept=n_kept,
        con_scale=con_scale,
        obj_scale=obj_scale,
        minimize=qp.minimize,
        ineq_rows=ineq_rows,
    )

    # Initial point in internal coordinates: slacks start at scaled A x0.
    s0 = con_scale[ineq_rows] * np.asarray(A_kept[ineq_rows] @ x0_kept).ravel()
    x0_int = np.concatenate([x0_kept, s0])
    y0_int = qp.y0 / np.maximum(con_scale, 1e-300) * obj_scale
    return std, info, x0_int, y0_int


def build_standard_form(
    qp: QuadraticProblem,
    scaling: bool = True,
    max_gradient: float = 100.0,
    fixed_variable_treatment: str = "make_parameter",
    bound_relax_factor: float = 1e-8,
) -> tuple[StandardQP, TransformInfo, np.ndarray, np.ndarray]:
    """Dense-path standard form: the sparse core, densified (SURVEY §7.1:
    dense padded arrays beat sparse on the device for moderate n)."""
    std_sp, info, x0_int, y0_int = build_standard_form_sparse(
        qp, scaling=scaling, max_gradient=max_gradient,
        fixed_variable_treatment=fixed_variable_treatment,
        bound_relax_factor=bound_relax_factor,
    )
    return std_sp.densify(), info, x0_int, y0_int
