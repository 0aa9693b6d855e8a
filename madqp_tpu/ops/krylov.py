"""Jittable preconditioned Krylov solvers for the sparse endgame.

The two-phase mixed-precision scheme's f64 endgame needs an f64
supernodal factorization, a second large program to compile.  Stationary
iterative refinement against an f32 factor stalls short of 1e-8 once
eps_f32 * cond(K) ~ 1, but the same f32 factor used as a
PRECONDITIONER for f64 conjugate gradients converges: CG only needs the
preconditioned spectrum clustered, not the contraction |I - M^-1 K| < 1.
Reference hook: the residual-check/refinement seam of
src/linear_solver.jl:28-43.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def pcg(matvec, precond, b, tol_rel: float = 1e-12, maxit: int = 64):
    """Preconditioned conjugate gradients for SPD systems, fully traced.

    Stops when ||r||_2 <= tol_rel * ||b||_2 or at maxit.  Returns (x, k).
    matvec/precond must be linear and SPD; b and all iterates are f64.
    """
    r0n = jnp.dot(b, b)
    z0 = precond(b)

    def cond(carry):
        _x, r, _z, _p, _rz, k = carry
        return (k < maxit) & (jnp.dot(r, r) > (tol_rel * tol_rel) * r0n)

    def body(carry):
        x, r, z, p, rz, k = carry
        Ap = matvec(p)
        pAp = jnp.dot(p, Ap)
        alpha = rz / jnp.where(pAp != 0.0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.where(rz != 0.0, rz, 1.0)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, _z, _p, _rz, k = lax.while_loop(
        cond, body,
        (jnp.zeros_like(b), b, z0, z0, jnp.dot(b, z0), jnp.int32(0)),
    )
    return x, k
