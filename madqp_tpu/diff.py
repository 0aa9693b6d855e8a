"""Differentiable QP solves: implicit differentiation through the KKT system.

A capability the reference cannot offer (it is a Julia solver with no AD
story): `qp_layer` is a JAX-transformable function whose output is the
optimal primal-dual point of a convex QP and whose VJP is computed by the
implicit function theorem on the KKT conditions — usable under `grad`,
`jit`, and `vmap` (batched differentiable QP layers on the device, the
OptNet pattern).

Math.  At a solution w* = (x, y, zl, zu) of

    min ½ xᵀHx + cᵀx   s.t.  Ax = b,   lb ≤ x ≤ ub

the KKT residual F(w; θ) = 0 with θ = (H, c, A, b, lb, ub) is

    F1 = Hx + c + Aᵀy − zl + zu        (dual feasibility, the solver's
                                        convention — see ops/kernels.py
                                        dual_infeasibility)
    F2 = Ax − b
    F3 = zl ∘ (x − lb)                 (complementarity; rows without a
    F4 = zu ∘ (ub − x)                  lower/upper bound read zl_i = 0 /
                                        zu_i = 0 instead)

Differentiating and eliminating (dzl, dzu) — exactly the condensation the
forward solver performs每 iteration — reduces the adjoint system
J_wᵀ u = w̄ to the SAME symmetric K2 augmented matrix the solver
factorizes at the solution:

    [[H + Σ, Aᵀ],        ux = K2⁻¹ [x̄ − zl∘z̄l/sl + zu∘z̄u/su]
     [A,     0 ]]        uy        [ȳ]

with sl = x − lb, su = ub − x, Σ = zl/sl + zu/su, and then

    ul = (z̄l + ux)/sl,   uu = (z̄u − ux)/su
    c̄  = −ux             b̄  = uy
    H̄  = −(ux xᵀ + x uxᵀ)/2          (symmetrized: H is symmetric data)
    Ā  = −(y uxᵀ + uy xᵀ)
    lb̄ = zl ∘ ul         ub̄ = −zu ∘ uu

Validity: gradients are exact where the solution is differentiable
(strict complementarity + LICQ); at degenerate points they are a
particular subgradient.  For LPs (H = 0) the solution is piecewise
constant in θ, so gradients are zero almost everywhere — use a small
quadratic regularizer if you need informative LP gradients.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .solver.mpc import MPCKernel
from .solver.state import ProblemArrays
from .utils.options import load_options


class QPLayerSolution(NamedTuple):
    """Primal-dual solution returned by qp_layer.  x, y, zl, zu are
    differentiable; status/iters are integer diagnostics (zero cotangent)."""

    x: jax.Array
    y: jax.Array
    zl: jax.Array
    zu: jax.Array
    status: jax.Array   # in-loop code: 1 = success (solver/state.py)
    iters: jax.Array


_BIG = 1e20  # sentinel for missing bounds (finite: 0*inf traps, SURVEY §7.3)


@functools.lru_cache(maxsize=32)
def _build_layer(opts_key):
    """One custom_vjp function per option set (options are static)."""
    opts = dict(opts_key)
    diff_reg = float(opts.pop("diff_reg", 0.0))
    ipm_opts, _ = load_options(**opts)
    kernel = MPCKernel(ipm_opts)
    dtype = jnp.dtype(ipm_opts.dtype)

    # jit here, not just at the caller: un-jitted, the solver's
    # lax.while_loop would re-trace (and re-COMPILE) on every call —
    # pathological for finite differences or any loop over instances.
    @jax.jit
    def _solve(H, c, A, b, lb, ub):
        has_lb = jnp.isfinite(lb)
        has_ub = jnp.isfinite(ub)
        lb = jnp.where(has_lb, lb, -_BIG).astype(dtype)
        ub = jnp.where(has_ub, ub, _BIG).astype(dtype)
        p = ProblemArrays(
            c0=jnp.zeros((), dtype), c=c.astype(dtype),
            H=H.astype(dtype), A=A.astype(dtype), b=b.astype(dtype),
            has_lb=has_lb, has_ub=has_ub,
        )
        x0 = jnp.zeros_like(p.c)
        y0 = jnp.zeros_like(p.b)
        final = kernel.solve_from(p, x0, y0, lb, ub)
        return final, has_lb, has_ub

    @jax.custom_vjp
    def layer(H, c, A, b, lb, ub):
        final, _, _ = _solve(H, c, A, b, lb, ub)
        return QPLayerSolution(final.x, final.y, final.zl, final.zu,
                               final.status, final.k)

    def fwd(H, c, A, b, lb, ub):
        final, has_lb, has_ub = _solve(H, c, A, b, lb, ub)
        out = QPLayerSolution(final.x, final.y, final.zl, final.zu,
                              final.status, final.k)
        # Residuals: the state's (possibly relaxed) bounds keep sl, su > 0.
        res = (H.astype(dtype), A.astype(dtype), final.x, final.y,
               final.zl, final.zu, final.lb, final.ub, has_lb, has_ub)
        return out, res

    def bwd(res, cot):
        H, A, x, y, zl, zu, lb, ub, has_lb, has_ub = res
        xb, yb = cot.x, cot.y
        # Integer outputs arrive as float0 cotangents; zl/zu may be None-like
        # zeros when the caller only uses x.
        zlb = cot.zl if cot.zl is not None else jnp.zeros_like(x)
        zub = cot.zu if cot.zu is not None else jnp.zeros_like(x)

        one = jnp.ones_like(x)
        sl = jnp.where(has_lb, x - lb, one)   # D in the derivation above
        su = jnp.where(has_ub, ub - x, one)
        sigma = zl / sl + zu / su

        n, m = x.shape[0], y.shape[0]
        K2 = jnp.block([
            [H + jnp.diag(sigma + diff_reg), A.T],
            [A, -diff_reg * jnp.eye(m, dtype=x.dtype)],
        ])
        rhs = jnp.concatenate([xb - zl * zlb / sl + zu * zub / su, yb])
        u = jnp.linalg.solve(K2, rhs)
        ux, uy = u[:n], u[n:]

        ul = (zlb + ux) / sl
        uu = (zub - ux) / su
        Hb = -0.5 * (jnp.outer(ux, x) + jnp.outer(x, ux))
        cb = -ux
        Ab = -(jnp.outer(y, ux) + jnp.outer(uy, x))
        bb = uy
        lbb = jnp.where(has_lb, zl * ul, 0.0)
        ubb = jnp.where(has_ub, -zu * uu, 0.0)
        return Hb, cb, Ab, bb, lbb, ubb

    layer.defvjp(fwd, bwd)
    return layer


def _opts_key(options):
    return tuple(sorted(options.items()))


def qp_layer(H, c, A, b, lb=None, ub=None, **options) -> QPLayerSolution:
    """Differentiable solve of  min ½xᵀHx + cᵀx  s.t. Ax = b, lb ≤ x ≤ ub.

    All six array arguments are differentiable (H=None means an LP — a
    zero Hessian is substituted; LP solutions are piecewise constant in
    the data, so their gradients vanish almost everywhere).  Missing
    bounds may be ±inf entries or None.  Extra kwargs are solver options
    (tol, max_iter, ... — utils/options.py) plus `diff_reg`, a Tikhonov
    term added to the adjoint K2 system for degenerate solutions.

    Works under jit / vmap / grad.  No presolve or scaling runs here:
    the map θ → x* must stay pure in the inputs.
    """
    c = jnp.asarray(c)
    n = c.shape[0]
    A = jnp.asarray(A)
    if H is None:
        H = jnp.zeros((n, n), c.dtype)
    lb = jnp.full((n,), -jnp.inf) if lb is None else jnp.asarray(lb)
    ub = jnp.full((n,), jnp.inf) if ub is None else jnp.asarray(ub)
    layer = _build_layer(_opts_key(options))
    return layer(jnp.asarray(H), c, A, jnp.asarray(b), lb, ub)


def qp_layer_general(H, c, A, lcon, ucon, lb=None, ub=None,
                     **options) -> QPLayerSolution:
    """Differentiable solve of the general box form
    min ½xᵀHx + cᵀx  s.t. lcon ≤ Ax ≤ ucon, lb ≤ x ≤ ub.

    Reformulated with slack variables s (Ax − s = 0, lcon ≤ s ≤ ucon) —
    the standard-form transform (models/qp.py) done traceably, so
    gradients w.r.t. lcon/ucon flow through the slack bounds.  Returns
    the solution restricted to the original variables; `y` are the
    multipliers of Ax − s = 0 (the constraint duals).
    """
    c = jnp.asarray(c)
    A = jnp.asarray(A)
    m, n = A.shape
    lcon = jnp.asarray(lcon)
    ucon = jnp.asarray(ucon)
    lb = jnp.full((n,), -jnp.inf) if lb is None else jnp.asarray(lb)
    ub = jnp.full((n,), jnp.inf) if ub is None else jnp.asarray(ub)

    if H is None:
        H = jnp.zeros((n, n), c.dtype)
    Hs = jnp.zeros((n + m, n + m), c.dtype).at[:n, :n].set(H)
    cs = jnp.concatenate([c, jnp.zeros((m,), c.dtype)])
    As = jnp.concatenate([A, -jnp.eye(m, dtype=A.dtype)], axis=1)
    bs = jnp.zeros((m,), c.dtype)
    sol = qp_layer(Hs, cs, As, bs,
                   jnp.concatenate([lb, lcon]),
                   jnp.concatenate([ub, ucon]), **options)
    return QPLayerSolution(sol.x[:n], sol.y, sol.zl[:n], sol.zu[:n],
                           sol.status, sol.iters)
