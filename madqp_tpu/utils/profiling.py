"""Profiling utilities (reference SURVEY §5.1 tracing/profiling parity).

The reference exposes timing counters plus a per-iteration log; here we add
XLA profiler integration (named scopes are emitted by solver/mpc.py around
the factorization / predictor / corrector stages) and a solve-stage timing
helper.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA profiler trace of the enclosed block (viewable with
    TensorBoard / xprof).  The mpc iteration's named scopes
    (kkt_factorize / predictor / corrector) appear in the trace."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_solve_stages(solver, reps: int = 3) -> dict:
    """End-to-end stage timings for an MPCSolver: init (starting point) vs
    full solve, averaged over `reps` runs.  Returns seconds per stage and
    per iteration."""
    init_t = []
    solve_t = []
    iters = 0
    for _ in range(reps):
        t0 = time.time()
        state = solver._init_jit(
            solver.prob, solver._x0, solver._y0, solver._lb0, solver._ub0
        )
        jax.block_until_ready(state)
        init_t.append(time.time() - t0)
        t0 = time.time()
        final = solver._solve_jit(
            solver.prob, solver._x0, solver._y0, solver._lb0, solver._ub0
        )
        jax.block_until_ready(final)
        solve_t.append(time.time() - t0)
        iters = int(final.k)
    init_s = sum(init_t) / reps
    solve_s = sum(solve_t) / reps
    return {
        "init_s": init_s,
        "solve_s": solve_s,
        "iters": iters,
        "s_per_iter": (solve_s - init_s) / max(1, iters),
    }
