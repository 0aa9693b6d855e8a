"""Masked IPM math kernels (JAX twin of reference src/kernels.jl).

Accelerator-first design decisions (SURVEY §7.1):
  * The reference's `ind_lb`/`ind_ub` gather views (SubVector) become boolean
    masks `has_lb`/`has_ub` over full-length arrays — masked dense arithmetic
    vectorizes and avoids gathers.
  * Bound-dual vectors `zl`/`zu` are full-length with zeros off-mask.
  * `lb`/`ub` are pre-sanitized finite placeholders off-mask so no 0*inf NaNs.
  * Scalar decisions (ratio tests, barrier) are on-device reductions that feed
    `lax.while_loop` carries — no host sync inside the hot loop.

Sign conventions for the unreduced KKT system (rows for masked entries only):

    [x ]  (H + dw I) dx + A' dy - dzl + dzu        = px
    [y ]  A dx + dc dy                             = py
    [zl]  zl.dx + sl.dzl                           = pzl     sl = x - lb > 0
    [zu]  -zu.dx + su.dzu                          = pzu     su = ub - x > 0

The lower-bound row matches the reference exactly; the upper-bound row is the
negation of the reference's (which uses u_diag = x - xu < 0), chosen so both
slack diagonals are positive.  Affine RHS: pzl = -sl.zl, pzu = -su.zu
(reference set_predictive_rhs!, src/kernels.jl:21-41 modulo the sign flip).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class KKTVec(NamedTuple):
    """Unreduced KKT vector: (x, y, zl, zu) blocks, zl/zu masked full-length.

    Replaces MadNLP.UnreducedKKTVector (reference src/structure.jl:130-133).
    """

    x: jax.Array   # (n,)
    y: jax.Array   # (m,)
    zl: jax.Array  # (n,)
    zu: jax.Array  # (n,)

    def flat_inf_norm(self) -> jax.Array:
        return jnp.maximum(
            jnp.maximum(_inf_norm(self.x), _inf_norm(self.y)),
            jnp.maximum(_inf_norm(self.zl), _inf_norm(self.zu)),
        )


def _inf_norm(v: jax.Array) -> jax.Array:
    return jnp.max(jnp.abs(v)) if v.size else jnp.zeros((), v.dtype)


def slacks(x, lb, ub, has_lb, has_ub):
    """Positive bound slacks, 1.0 off-mask (never used off-mask)."""
    sl = jnp.where(has_lb, x - lb, 1.0)
    su = jnp.where(has_ub, ub - x, 1.0)
    return sl, su


# ---------------------------------------------------------------------------
# Diagonal / Sigma (reference set_aug_diagonal_reg!, src/kernels.jl:128-146)
# ---------------------------------------------------------------------------


def sigma_diagonal(x, lb, ub, has_lb, has_ub, zl, zu, del_w):
    """pr_diag = del_w + zl/(x-lb) + zu/(ub-x), masked."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    return (
        del_w
        + jnp.where(has_lb, zl / sl, 0.0)
        + jnp.where(has_ub, zu / su, 0.0)
    )


# ---------------------------------------------------------------------------
# RHS builders (reference src/kernels.jl:1-61)
# ---------------------------------------------------------------------------


def initial_primal_rhs(c_res, n, dtype):
    """rhs = (0, -c_res, 0, 0): primal least-squares (src/kernels.jl:1-9)."""
    z = jnp.zeros(n, dtype)
    return KKTVec(x=z, y=-c_res, zl=z, zu=z)


def initial_dual_rhs(g, m, dtype):
    """rhs = (-g, 0, 0, 0): dual least-squares (src/kernels.jl:11-19)."""
    z = jnp.zeros(g.shape[0], dtype)
    return KKTVec(x=-g, y=jnp.zeros(m, dtype), zl=z, zu=z)


def predictor_rhs(g, jacl, c_res, x, lb, ub, has_lb, has_ub, zl, zu):
    """Affine-scaling RHS (reference set_predictive_rhs!)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    return KKTVec(
        x=-g + zl - zu - jacl,
        y=-c_res,
        zl=jnp.where(has_lb, -sl * zl, 0.0),
        zu=jnp.where(has_ub, -su * zu, 0.0),
    )


def correction_rhs(g, jacl, c_res, x, lb, ub, has_lb, has_ub, zl, zu, mu,
                   correction_lb, correction_ub):
    """Corrector RHS (reference set_correction_rhs!, src/kernels.jl:43-61).

    pzl = -sl.zl + mu - corr_lb ; pzu = -su.zu + mu + corr_ub (sign flip of
    the upper row relative to the reference, see module docstring).
    """
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    return KKTVec(
        x=-g + zl - zu - jacl,
        y=-c_res,
        zl=jnp.where(has_lb, -sl * zl + mu - correction_lb, 0.0),
        zu=jnp.where(has_ub, -su * zu + mu + correction_ub, 0.0),
    )


def mehrotra_correction(d: KKTVec, has_lb, has_ub):
    """corr = dx .* dz from the affine direction (src/kernels.jl:63-75)."""
    corr_lb = jnp.where(has_lb, d.x * d.zl, 0.0)
    corr_ub = jnp.where(has_ub, d.x * d.zu, 0.0)
    return corr_lb, corr_ub


def gondzio_extra_correction(
    d: KKTVec, x, lb, ub, has_lb, has_ub, zl, zu,
    correction_lb, correction_ub,
    alpha_p, alpha_d, beta_min, beta_max, mu,
):
    """Gondzio's multi-centrality correction (src/kernels.jl:78-126).

    Clamp the trial complementarity products into [beta_min*mu, beta_max*mu];
    the excess delta is folded into the corrections.
    """
    tmin, tmax = beta_min * mu, beta_max * mu
    sl, su = slacks(x, lb, ub, has_lb, has_ub)

    v_l = (sl + alpha_p * d.x) * (zl + alpha_d * d.zl)
    delta_l = jnp.where(v_l < tmin, tmin - v_l, jnp.where(v_l > tmax, tmax - v_l, 0.0))
    new_corr_lb = jnp.where(has_lb, correction_lb - delta_l, 0.0)

    v_u = (su - alpha_p * d.x) * (zu + alpha_d * d.zu)
    delta_u = jnp.where(v_u < tmin, tmin - v_u, jnp.where(v_u > tmax, tmax - v_u, 0.0))
    new_corr_ub = jnp.where(has_ub, correction_ub + delta_u, 0.0)

    return new_corr_lb, new_corr_ub


# ---------------------------------------------------------------------------
# Bound-dual elimination / recovery (MadNLP reduce_rhs!/finish_aug_solve!)
# ---------------------------------------------------------------------------


def reduce_rhs(p: KKTVec, x, lb, ub, has_lb, has_ub):
    """Condense the bound-dual rows into the primal RHS:
    px~ = px + pzl/sl - pzu/su."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    px = p.x + jnp.where(has_lb, p.zl / sl, 0.0) - jnp.where(has_ub, p.zu / su, 0.0)
    return px, p.y


def recover_bound_duals(p: KKTVec, dx, x, lb, ub, has_lb, has_ub, zl, zu):
    """dzl = (pzl - zl.dx)/sl ; dzu = (pzu + zu.dx)/su (masked)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    dzl = jnp.where(has_lb, (p.zl - zl * dx) / sl, 0.0)
    dzu = jnp.where(has_ub, (p.zu + zu * dx) / su, 0.0)
    return dzl, dzu


# ---------------------------------------------------------------------------
# Complementarity measures (src/kernels.jl:171-224)
# ---------------------------------------------------------------------------


def complementarity_measure(x, lb, ub, has_lb, has_ub, zl, zu):
    """mu = (sum (x-lb).zl + sum (ub-x).zu) / (nlb + nub); 0 if no bounds."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    num = jnp.sum(jnp.where(has_lb, sl * zl, 0.0)) + jnp.sum(
        jnp.where(has_ub, su * zu, 0.0)
    )
    cnt = jnp.sum(has_lb) + jnp.sum(has_ub)
    return jnp.where(cnt > 0, num / jnp.maximum(cnt, 1), 0.0)


def affine_complementarity_measure(
    d: KKTVec, x, lb, ub, has_lb, has_ub, zl, zu, alpha_p, alpha_d
):
    """Trial complementarity at (x + a_p dx, z + a_d dz) (src/kernels.jl:192-224)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    num = jnp.sum(
        jnp.where(has_lb, (sl + alpha_p * d.x) * (zl + alpha_d * d.zl), 0.0)
    ) + jnp.sum(
        jnp.where(has_ub, (su - alpha_p * d.x) * (zu + alpha_d * d.zu), 0.0)
    )
    cnt = jnp.sum(has_lb) + jnp.sum(has_ub)
    return jnp.where(cnt > 0, num / jnp.maximum(cnt, 1), 0.0)


def optimality_gap(x, lb, ub, has_lb, has_ub, zl, zu):
    """inf-norm of the complementarity products (get_optimality_gap)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    gl = jnp.where(has_lb, jnp.abs(sl * zl), 0.0)
    gu = jnp.where(has_ub, jnp.abs(su * zu), 0.0)
    return jnp.maximum(_inf_norm(gl), _inf_norm(gu))


# ---------------------------------------------------------------------------
# Fraction-to-boundary ratio tests (src/kernels.jl:242-305)
# ---------------------------------------------------------------------------

_BIG = jnp.inf


def alpha_max_primal(x, lb, ub, has_lb, has_ub, dx, tau):
    """Largest alpha <= 1 keeping x + alpha dx inside tau-shrunk bounds.

    Returns (alpha_xl, alpha_xu, iblock_l, iblock_u) like the reference's
    argmin-carrying mapreduce (get_alpha_max_primal).
    """
    cond_l = has_lb & (dx < 0)
    vals_l = jnp.where(cond_l, tau * (lb - x) / jnp.where(cond_l, dx, -1.0), _BIG)
    cond_u = has_ub & (dx > 0)
    vals_u = jnp.where(cond_u, tau * (ub - x) / jnp.where(cond_u, dx, 1.0), _BIG)
    alpha_l = jnp.minimum(1.0, jnp.min(vals_l, initial=_BIG))
    alpha_u = jnp.minimum(1.0, jnp.min(vals_u, initial=_BIG))
    return alpha_l, alpha_u, jnp.argmin(vals_l), jnp.argmin(vals_u)


def alpha_max_dual(zl, zu, has_lb, has_ub, dzl, dzu, tau):
    """Largest alpha <= 1 keeping z + alpha dz > 0 (tau-shrunk).

    The upper-dual test replicates the reference's extra guard
    `(dzu < 0) && (zu + dzu < 0)` (src/kernels.jl:279).
    """
    cond_l = has_lb & (dzl < 0)
    vals_l = jnp.where(cond_l, -tau * zl / jnp.where(cond_l, dzl, -1.0), _BIG)
    cond_u = has_ub & (dzu < 0) & (zu + dzu < 0)
    vals_u = jnp.where(cond_u, -tau * zu / jnp.where(cond_u, dzu, -1.0), _BIG)
    alpha_l = jnp.minimum(1.0, jnp.min(vals_l, initial=_BIG))
    alpha_u = jnp.minimum(1.0, jnp.min(vals_u, initial=_BIG))
    return alpha_l, alpha_u, jnp.argmin(vals_l), jnp.argmin(vals_u)


def fraction_to_boundary(d: KKTVec, x, lb, ub, has_lb, has_ub, zl, zu, tau):
    """(alpha_p, alpha_d) (reference get_fraction_to_boundary_step)."""
    axl, axu, _, _ = alpha_max_primal(x, lb, ub, has_lb, has_ub, d.x, tau)
    azl, azu, _, _ = alpha_max_dual(zl, zu, has_lb, has_ub, d.zl, d.zu, tau)
    return jnp.minimum(axl, axu), jnp.minimum(azl, azu)


# ---------------------------------------------------------------------------
# Step rules (src/kernels.jl:307-374)
# ---------------------------------------------------------------------------


def step_conservative(d, x, lb, ub, has_lb, has_ub, zl, zu, mu, tau):
    return fraction_to_boundary(d, x, lb, ub, has_lb, has_ub, zl, zu, tau)


def step_adaptive(d, x, lb, ub, has_lb, has_ub, zl, zu, mu, tau_min):
    tau = jnp.maximum(1.0 - mu, tau_min)
    return fraction_to_boundary(d, x, lb, ub, has_lb, has_ub, zl, zu, tau)


def step_mehrotra_adaptive(d, x, lb, ub, has_lb, has_ub, zl, zu, mu, gamma_f):
    """Mehrotra's GTSF heuristic (src/kernels.jl:325-374).

    The reference's scalar blocking-index reads become argmin + take inside
    jit (SURVEY §7.1).
    """
    gamma_a = 1.0 / (1.0 - gamma_f)

    axl, axu, i_xl, i_xu = alpha_max_primal(x, lb, ub, has_lb, has_ub, d.x, 1.0)
    azl, azu, i_zl, i_zu = alpha_max_dual(zl, zu, has_lb, has_ub, d.zl, d.zu, 1.0)

    max_alpha_p = jnp.minimum(axl, axu)
    max_alpha_d = jnp.minimum(azl, azu)

    mu_full = affine_complementarity_measure(
        d, x, lb, ub, has_lb, has_ub, zl, zu, max_alpha_p, max_alpha_d
    ) / gamma_a

    sl, su = slacks(x, lb, ub, has_lb, has_ub)

    # Primal rescue at the blocking index.
    def rescue_p_l():
        i = i_xl
        tmp = mu_full / (zl[i] + max_alpha_d * d.zl[i])
        return (sl[i] - tmp) / (-d.x[i])  # (x - lb - tmp)/(-dx)

    def rescue_p_u():
        i = i_xu
        tmp = mu_full / (zu[i] + max_alpha_d * d.zu[i])
        return (su[i] - tmp) / d.x[i]

    alpha_p_resc = jnp.where(axl <= axu, rescue_p_l(), rescue_p_u())
    alpha_p = jnp.where(max_alpha_p < 1.0, alpha_p_resc, 1.0)

    def rescue_d_l():
        i = i_zl
        tmp = mu_full / (sl[i] + max_alpha_p * d.x[i])
        return -(zl[i] - tmp) / d.zl[i]

    def rescue_d_u():
        i = i_zu
        tmp = mu_full / (su[i] - max_alpha_p * d.x[i])
        return -(zu[i] - tmp) / d.zu[i]

    alpha_d_resc = jnp.where(azl <= azu, rescue_d_l(), rescue_d_u())
    alpha_d = jnp.where(max_alpha_d < 1.0, alpha_d_resc, 1.0)

    alpha_p = jnp.maximum(alpha_p, gamma_f * max_alpha_p)
    alpha_d = jnp.maximum(alpha_d, gamma_f * max_alpha_d)
    # Never exceed the strict fraction-to-boundary maximum.
    alpha_p = jnp.minimum(alpha_p, max_alpha_p)
    alpha_d = jnp.minimum(alpha_d, max_alpha_d)
    return alpha_p, alpha_d


# ---------------------------------------------------------------------------
# Barrier (src/kernels.jl:226-236)
# ---------------------------------------------------------------------------


def mehrotra_barrier(
    mu_curr, mu_affine, n_onesided, mu_min, sigma_min=1e-6, sigma_max=10.0
):
    """sigma = clamp((mu_aff/mu)^3, smin, smax) when one-sided bounds exist,
    else sigma = 1 (reference update_barrier!).  `n_onesided` is the static
    count of variables with exactly one finite bound."""
    ratio = jnp.where(mu_curr > 0, mu_affine / jnp.maximum(mu_curr, 1e-300), 0.0)
    sigma = jnp.clip(ratio ** 3, sigma_min, sigma_max)
    sigma = jnp.where(n_onesided > 0, sigma, 1.0)
    return jnp.maximum(mu_min, sigma * mu_curr)


# ---------------------------------------------------------------------------
# Dual objective / residual norms (src/kernels.jl:424-446)
# ---------------------------------------------------------------------------


def dual_objective(y, b, lb, ub, has_lb, has_ub, zl, zu):
    """-y'b + zl'lb - zu'ub over finite bounds (reference dual_objective)."""
    out = -jnp.dot(y, b) if y.size else jnp.zeros((), lb.dtype)
    out = out + jnp.sum(jnp.where(has_lb, zl * lb, 0.0))
    out = out - jnp.sum(jnp.where(has_ub, zu * ub, 0.0))
    return out


def dual_infeasibility(g, jacl, zl, zu):
    """||g + A'y - zl + zu||_inf (MadNLP get_inf_du with sd=1)."""
    return _inf_norm(g + jacl - zl + zu)


def primal_infeasibility(c_res):
    """||A x - b||_inf (MadNLP get_inf_pr)."""
    return _inf_norm(c_res)


# ---------------------------------------------------------------------------
# Initialization helpers (reference src/solver.jl:6-124 + MadNLP initialize!)
# ---------------------------------------------------------------------------


def relax_bounds(lb, ub, has_lb, has_ub, tol):
    """MadNLP bound_relax_factor semantics: relax each finite bound by
    tol * max(1, |bound|)."""
    lb2 = jnp.where(has_lb, lb - tol * jnp.maximum(1.0, jnp.abs(lb)), lb)
    ub2 = jnp.where(has_ub, ub + tol * jnp.maximum(1.0, jnp.abs(ub)), ub)
    return lb2, ub2


def push_inside_bounds(x, lb, ub, has_lb, has_ub, bound_push, bound_fac):
    """Ipopt-style initial push of x strictly inside its bounds."""
    width = jnp.where(
        has_lb & has_ub, ub - lb, jnp.inf
    )
    pl = jnp.minimum(bound_push * jnp.maximum(1.0, jnp.abs(lb)), bound_fac * width)
    pu = jnp.minimum(bound_push * jnp.maximum(1.0, jnp.abs(ub)), bound_fac * width)
    x = jnp.where(has_lb, jnp.maximum(x, lb + pl), x)
    x = jnp.where(has_ub, jnp.minimum(x, ub - pu), x)
    return x


def project_bound_fac(x, lb, ub, has_lb, has_ub, kappa):
    """Ipopt projection used by the Mehrotra starting point
    (reference src/solver.jl:101-118): note max(1, l) — not abs — faithfully
    reproduced."""
    lb_inf = jnp.where(has_lb, lb, -jnp.inf)
    ub_inf = jnp.where(has_ub, ub, jnp.inf)
    width = ub_inf - lb_inf
    pl = jnp.minimum(kappa * jnp.maximum(1.0, lb_inf), kappa * width)
    pu = jnp.minimum(kappa * jnp.maximum(1.0, ub_inf), kappa * width)
    x = jnp.where(has_lb & (x < lb_inf), lb_inf + pl, x)
    x = jnp.where(has_ub & (ub_inf < x), ub_inf - pu, x)
    return x


def init_bound_duals(r, has_lb, has_ub, zl_prev, zu_prev):
    """Mehrotra dual init from the dual residual r = g + A'y
    (reference src/solver.jl:37-66): two-sided bounds split r in half."""
    both = has_lb & has_ub
    zl = jnp.where(both, 0.5 * r, jnp.where(has_lb, r, zl_prev))
    zu = jnp.where(both, -0.5 * r, jnp.where(has_ub, -r, zu_prev))
    return jnp.where(has_lb, zl, 0.0), jnp.where(has_ub, zu, 0.0)


def mehrotra_positivity_shift(x, lb, ub, has_lb, has_ub, zl, zu):
    """Positivity shifts delta_x/delta_s + second-order shifts
    (reference src/solver.jl:68-99).  Two-sided x entries receive +delta then
    -delta (net zero), matching the reference's aliased views."""
    sl = jnp.where(has_lb, x - lb, jnp.inf)
    su = jnp.where(has_ub, ub - x, jnp.inf)
    min_sl = jnp.minimum(jnp.min(sl, initial=jnp.inf), jnp.inf)
    min_su = jnp.minimum(jnp.min(su, initial=jnp.inf), jnp.inf)
    min_sl = jnp.where(jnp.isfinite(min_sl), min_sl, 0.0)
    min_su = jnp.where(jnp.isfinite(min_su), min_su, 0.0)
    delta_x = jnp.maximum(0.0, jnp.maximum(-1.5 * min_sl, -1.5 * min_su))

    zl_min = jnp.min(jnp.where(has_lb, zl, jnp.inf), initial=jnp.inf)
    zu_min = jnp.min(jnp.where(has_ub, zu, jnp.inf), initial=jnp.inf)
    zl_min = jnp.where(jnp.isfinite(zl_min), zl_min, 0.0)
    zu_min = jnp.where(jnp.isfinite(zu_min), zu_min, 0.0)
    delta_s = jnp.maximum(0.0, jnp.maximum(-1.5 * zl_min, -1.5 * zu_min))

    # x shift: +delta on lb-only side, -delta on ub-only side, 0 two-sided.
    x = x + delta_x * (has_lb.astype(x.dtype) - has_ub.astype(x.dtype))
    zl = jnp.where(has_lb, zl + 1.0 + delta_s, 0.0)
    zu = jnp.where(has_ub, zu + 1.0 + delta_s, 0.0)

    # Second-order shifts.
    sl2 = jnp.where(has_lb, x - lb, 0.0)
    su2 = jnp.where(has_ub, ub - x, 0.0)
    mu0 = jnp.sum(jnp.where(has_lb, sl2 * zl, 0.0)) + jnp.sum(
        jnp.where(has_ub, su2 * zu, 0.0)
    )
    sum_z = jnp.sum(jnp.where(has_lb, zl, 0.0)) + jnp.sum(jnp.where(has_ub, zu, 0.0))
    sum_s = jnp.sum(sl2) + jnp.sum(su2)
    delta_x2 = jnp.where(sum_z > 0, mu0 / (2.0 * jnp.maximum(sum_z, 1e-300)), 0.0)
    delta_s2 = jnp.where(sum_s > 0, mu0 / (2.0 * jnp.maximum(sum_s, 1e-300)), 0.0)

    x = x + delta_x2 * (has_lb.astype(x.dtype) - has_ub.astype(x.dtype))
    zl = jnp.where(has_lb, zl + delta_s2, 0.0)
    zu = jnp.where(has_ub, zu + delta_s2, 0.0)
    return x, zl, zu


def adjust_boundary(x, lb, ub, has_lb, has_ub, mu, eps):
    """Relax bounds whose slack collapsed below eps*mu
    (MadNLP.adjust_boundary! called at reference src/solver.jl:342)."""
    c1 = eps * mu
    c2 = eps ** 0.75
    lb2 = jnp.where(
        has_lb & (x - lb < c1), lb - c2 * jnp.maximum(1.0, jnp.abs(x)), lb
    )
    ub2 = jnp.where(
        has_ub & (ub - x < c1), ub + c2 * jnp.maximum(1.0, jnp.abs(x)), ub
    )
    return lb2, ub2
