"""Solver state as an immutable pytree.

Functional replacement for the reference's mutable MPCSolver struct
(src/structure.jl:1-176): iteration is a pure function state -> state driven
by lax.while_loop (SURVEY §7.1).  Bounds live in the state because
adjust_boundary! mutates them (reference src/solver.jl:342).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.qp import StandardQP
from ..ops.kernels import KKTVec

# In-loop status codes (mapped to utils.Status by the driver).
RUNNING = 0
SUCCESS = 1
MAX_ITER = 2
STEP_ERROR = 3
DIVERGED = 4
STALLED = 5  # stall_exit iterations without progress (mixed-precision floor)


class ProblemArrays(NamedTuple):
    """Device-resident immutable problem data (dense path).

    The methods are the model-callback protocol consumed by MPCKernel and
    the KKT layer (reference SparseCallback analog, SURVEY L3): any problem
    representation exposing c0/c/b/has_lb/has_ub plus hess_mv/jac_mv/jac_rmv
    plugs into the same solver — this is how structured problems
    (parallel/structured.py) reuse the MPC core.
    """

    c0: jax.Array
    c: jax.Array
    H: Optional[jax.Array]
    A: jax.Array
    b: jax.Array
    has_lb: jax.Array
    has_ub: jax.Array

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def is_lp(self) -> bool:
        return self.H is None

    def hess_mv(self, x):
        """H @ x (zero for LPs)."""
        return jnp.zeros_like(x) if self.H is None else self.H @ x

    def jac_mv(self, x):
        """A @ x."""
        return self.A @ x

    def jac_rmv(self, y):
        """A' @ y."""
        return self.A.T @ y


class IPMState(NamedTuple):
    # Primal-dual iterate.
    x: jax.Array
    y: jax.Array
    zl: jax.Array   # masked full-length (0 off-mask)
    zu: jax.Array
    # Bounds (mutable: adjust_boundary / bound relaxation).
    lb: jax.Array
    ub: jax.Array
    # Current direction (for logging ||d|| and warm buffers).
    d: KKTVec
    # Barrier and regularization scalars.
    mu: jax.Array
    del_w: jax.Array
    del_c: jax.Array
    reg_p: jax.Array    # AdaptiveRegularization's evolving deltas
    reg_d: jax.Array
    # Step sizes.
    alpha_p: jax.Array
    alpha_d: jax.Array
    # Residual norms / objective (for convergence + logging).
    obj_val: jax.Array
    inf_pr: jax.Array
    inf_du: jax.Array
    inf_compl: jax.Array
    d_norm: jax.Array
    norm_b: jax.Array
    norm_c: jax.Array
    # Counters / status.
    k: jax.Array        # int32 iteration counter
    n_fact: jax.Array   # factorization count
    n_solve: jax.Array  # backsolve count
    status: jax.Array   # int32, RUNNING while iterating
    # Stall detection (options.stall_exit): best max-infeasibility seen and
    # the count of consecutive iterations without meaningful improvement.
    best_worst: jax.Array
    stall_k: jax.Array  # int32
    # False until the Mehrotra starting point (3 least-squares KKT solves,
    # reference src/solver.jl:6-125) has been computed.  The starting-point
    # work runs INSIDE the first `iteration` call (gated by this flag) so a
    # full solve traces exactly one factorize walk and one backsolve walk —
    # on the sparse supernodal paths each traced walk costs seconds of XLA
    # compile.
    initialized: jax.Array  # bool


def problem_to_device(std: StandardQP, dtype=jnp.float64) -> tuple[ProblemArrays, jax.Array, jax.Array]:
    """Move a StandardQP to device arrays of the requested dtype.

    Returns (prob, lb, ub) — bounds separately since they are state.
    """
    as_dev = lambda v: jnp.asarray(v, dtype=dtype)
    prob = ProblemArrays(
        c0=as_dev(std.c0),
        c=as_dev(std.c),
        H=None if std.H is None else as_dev(std.H),
        A=as_dev(std.A),
        b=as_dev(std.b),
        has_lb=jnp.asarray(std.has_lb),
        has_ub=jnp.asarray(std.has_ub),
    )
    return prob, as_dev(std.lb), as_dev(std.ub)


def count_onesided(std: StandardQP) -> int:
    """Static count of bounded entries — gates the Mehrotra sigma branch
    (reference update_barrier!, src/kernels.jl:226-236: sigma = 1 without
    'inequalities').  We gate on *any* finite bound existing: with no bounds
    the complementarity measure is identically zero and sigma is irrelevant,
    while with only two-sided bounds the cube rule is still required for the
    barrier to decrease (sigma = 1 provably stalls — verified empirically on
    the bounds-only QP the reference also tests as size (10, 0))."""
    return int(std.has_lb.sum() + std.has_ub.sum())
