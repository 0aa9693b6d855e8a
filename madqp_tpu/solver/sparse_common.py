"""Shared infrastructure for the on-device sparse KKT paths.

The sparse KKTs close over large NUMPY index arrays (symbolic schedule,
scatter maps) that XLA folds into the compiled program, so each
`jax.jit(kernel.solve_from)` is pattern-specific.  Re-tracing a 20k-variable
supernodal solve costs minutes — far more than the device time of the solve
itself.  This module provides:

- `canonical_csc(M)` — the ONE canonicalization both KKT constructors and
  value refills must share (CSC, summed duplicates, sorted indices);
- `pattern_fingerprint(...)` — sha1 over shapes + index structure, the
  cache key for "same sparsity, different values";
- `get_sparse_kernel(...)` — an LRU of (KKT, MPCKernel, jitted fns) keyed
  by (kind, fingerprint, options), so repeated solves of same-pattern
  problems (MPC re-solves, benchmark repeats, suite instances sharing a
  structure) skip symbolic analysis AND retrace entirely.

The reference has no analog: its CHOLMOD/cuDSS handles keep symbolic
objects alive per instance (src/linear_solver.jl), but tracing is not a
cost it pays.  Here the trace is a large fixed cost, so kernel identity
must be managed explicitly.  Compiled executables persist across processes
through JAX's own compilation cache (see the package __init__).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def canonical_csc(M: sp.spmatrix) -> sp.csc_matrix:
    """Canonical CSC form: duplicates summed, indices sorted.  COO export
    of this form (column-major) is the value order every sparse-KKT
    consumer assumes."""
    M = sp.csc_matrix(M)
    M.sum_duplicates()
    return M.sorted_indices()


def canonical_coo_vals(M: sp.spmatrix) -> np.ndarray:
    """Values of canonical_csc(M) in its COO (column-major) order."""
    return canonical_csc(M).tocoo().data.copy()


def pattern_fingerprint(A: sp.spmatrix,
                        H: Optional[sp.spmatrix] = None) -> str:
    """sha1 of the sparsity structure (not values) of A (and H)."""
    h = hashlib.sha1()
    for M in (A, H):
        if M is None:
            h.update(b"none")
            continue
        M = canonical_csc(M)
        h.update(np.asarray(M.shape, np.int64).tobytes())
        h.update(M.indptr.astype(np.int64).tobytes())
        h.update(M.indices.astype(np.int64).tobytes())
    return h.hexdigest()


_KERNEL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_KERNEL_CACHE_SIZE = 16  # each entry holds a symbolic schedule (MBs)


def get_sparse_kernel(kind: str, fingerprint: str, opts, make_kkt):
    """Return (kkt, kernel, jits) for this (kind, pattern, options),
    building via make_kkt() on a miss.  jits is the same dict shape as
    driver._jitted_kernel's."""
    import jax

    from .mpc import MPCKernel

    key = (kind, fingerprint, opts)
    hit = _KERNEL_CACHE.get(key)
    if hit is not None:
        _KERNEL_CACHE.move_to_end(key)
        return hit
    kkt = make_kkt()
    kernel = MPCKernel(opts, kkt=kkt)

    # Inject the KKT's device-resident symbolic index bundle as a jit
    # ARGUMENT (prob.idx): folding the gather/scatter index arrays as
    # host-numpy constants costs minutes of lower+compile per pattern.
    dev_idx = kkt.device_idx() if hasattr(kkt, "device_idx") else None

    def wrap(fn):
        jf = jax.jit(fn)
        if dev_idx is None:
            fix = lambda prob: prob  # noqa: E731
        else:
            fix = lambda prob: prob._replace(idx=dev_idx)  # noqa: E731

        execs: dict = {}

        def call(prob, *args):
            return jf(fix(prob), *args)

        def precompile(prob, *args):
            """AOT-compile for these arg shapes (once per process) and
            return a callable bound to the executable.  Used by the
            two-phase drivers to build phase 2 on a background thread while
            phase 1 runs."""
            a = (fix(prob),) + args
            sig = tuple((str(l.dtype), l.shape)
                        for l in jax.tree_util.tree_leaves(a)
                        if hasattr(l, "dtype"))
            if sig not in execs:
                execs[sig] = jf.lower(*a).compile()
            run = execs[sig]

            def bound(prob, *args):
                return run(fix(prob), *args)

            return bound

        call.precompile = precompile
        return call

    jits = {
        "solve": wrap(kernel.solve_from),
        "iter": wrap(kernel.iteration),
        "run_k": wrap(kernel.run_k),
        "init": wrap(kernel.init_state),
        "warm_solve": wrap(kernel.solve_from_warm),
        "warm_init": wrap(kernel.init_state_warm),
    }
    _KERNEL_CACHE[key] = (kkt, kernel, jits)
    while len(_KERNEL_CACHE) > _KERNEL_CACHE_SIZE:
        _KERNEL_CACHE.popitem(last=False)
    return kkt, kernel, jits


def stepped_solve(jits, prob, x0, y0, lb, ub, warm=None):
    """Host-stepped solve: dispatch the jitted `iteration` program per step
    instead of compiling one lax.while_loop mega-program.

    Cold-compile economics on the sparse supernodal paths: the while-loop
    wrapper costs more XLA compile than the iteration program it wraps,
    while host stepping adds only a per-iteration dispatch + status
    readback.  loop_mode='python' selects this loop; loop_mode='jit'
    forces the single-program mode for hot re-solve loops."""
    import jax

    if warm is not None:
        zl0, zu0 = warm
        state = jits["warm_init"](prob, x0, y0, zl0, zu0, lb, ub)
    else:
        state = jits["init"](prob, x0, y0, lb, ub)
    # Pipelined stepping: `iteration` is terminal-safe (it re-derives the
    # status from residuals and lax.cond's into a no-op `finish` branch on
    # non-RUNNING states, mpc.py), so the loop can dispatch several
    # iterations per status readback instead of paying a full device
    # sync every step.  The first few steps sync every
    # iteration (cheap solves terminate in ~10), then the stride grows to
    # 4: at most 3 trailing no-op dispatches (an SpMV each, no
    # factorization) are wasted on termination.
    steps = 0
    while int(jax.device_get(state.status)) == 0:  # state.RUNNING
        chunk = 1 if steps < 4 else 4
        for _ in range(chunk):
            state = jits["iter"](prob, state)
        steps += chunk
    return state


def chunked_solve(jits, prob, x0, y0, lb, ub, warm=None, chunk=16):
    """Host-chunked solve: dispatch bounded while_loop chunks of up to
    `chunk` iterations (kernel.run_k) with one status readback between
    chunks.

    Compared to stepped_solve (one sync per iteration) this pays ~1/chunk
    of the host sync cost; compared to the full while_loop it bounds every
    dispatch's wall.  run_k's while_loop cond exits the moment the
    status leaves RUNNING, so a generous chunk costs NO trailing no-op
    work — only the bounded possibility of a longer final dispatch."""
    import jax
    import jax.numpy as jnp

    if warm is not None:
        zl0, zu0 = warm
        state = jits["warm_init"](prob, x0, y0, zl0, zu0, lb, ub)
    else:
        state = jits["init"](prob, x0, y0, lb, ub)
    k = jnp.int32(chunk)
    while int(jax.device_get(state.status)) == 0:  # RUNNING
        state = jits["run_k"](prob, state, k)
    return state


def dense_chunk_len(m, target_flops=2e11, lo=4, hi=64):
    """Chunk length for chunked_solve on the dense-normal/dense-condensed
    paths: bound one dispatch's factorization work (chunk * m^3/3 flops)
    by `target_flops`, clamped to [lo, hi]."""
    import numpy as np

    return int(np.clip(target_flops / max(1.0, float(m) ** 3 / 3.0),
                       lo, hi))


def start_phase2_overlap(kernel_for, opts2, dummy_args):
    """Build + AOT-compile the phase-2 warm_solve on a background thread.

    The two-phase scheme's cold cost is dominated by TWO serialized XLA
    compiles (phase-1 solve_from + phase-2 solve_from_warm).  Phase 2's
    compile needs only shapes, so it can run while phase 1 traces/compiles/
    executes — XLA compilation releases the GIL.  Returns finish(*args):
    joins the thread and runs the compiled executable (falling back to the
    plain jit call if precompilation failed)."""
    import threading

    box: dict = {}

    def work():
        try:
            _, _, jits2 = kernel_for(opts2)
            box["jits2"] = jits2
            box["run"] = jits2["warm_solve"].precompile(*dummy_args)
        except Exception as e:  # fall back to the blocking path
            box["err"] = e

    th = threading.Thread(target=work, daemon=True,
                          name="madqp-phase2-compile")
    th.start()

    def finish(*args):
        th.join()
        run = box.get("run")
        if run is not None:
            return run(*args)
        jits2 = box.get("jits2")
        if jits2 is None:
            _, _, jits2 = kernel_for(opts2)
        return jits2["warm_solve"](*args)

    return finish


def resolve_endgame(opts):
    """Resolve endgame='auto' for the sparse device drivers: 'host' when
    the native C++ LDL library is available (the f32 phase's terminal
    iterate warm-starts the host solver, so the f64 XLA programs never
    compile), else 'f64'."""
    if opts.endgame != "auto":
        return opts
    import dataclasses

    from ..native import available

    return dataclasses.replace(
        opts, endgame="host" if available() else "f64")


def two_phase_opts(opts, typed_phase1=False):
    """Split options for the two-phase mixed-precision scheme.

    typed_phase1: honor options.phase1_dtype for the phase-1 state (the
    caller must then build the problem arrays per phase and cast the
    warm-start on handoff — solver/sparse_{lp,qp,condensed}.py do; the
    dense driver and the batched paths share one f64 problem pytree
    across phases and keep the f64-state/f32-factorization scheme).

    Phase 1 (f32): solve to phase1_tol with stall detection on (an f32
    kernel at its precision floor burns iterations and degrades the warm
    start it hands over — measured: phase1_tol=1e-5 on a banded n=20k LP
    stalled for 42 extra f32 iterations and then needed 41 f64 endgame
    iterations instead of 5).

    Phase 2 (f64): phase-1-only fields are normalized away so the endgame
    kernel (and its jit cache entry) is shared across phase-1 settings.
    """
    import dataclasses

    opts1 = dataclasses.replace(
        opts, tol=opts.phase1_tol,
        stall_exit=opts.stall_exit if opts.stall_exit > 0 else 5,
        max_iter=min(opts.max_iter, opts.phase1_max_iter),
        # Fully-typed phase 1 (see options.phase1_dtype): phase 1 only
        # needs phase1_tol.
        dtype=(opts.phase1_dtype or opts.dtype) if typed_phase1
        else opts.dtype,
    )
    if opts.endgame == "krylov":
        # keep the f32 factorization plan; phase 2 solves in f64 via
        # preconditioned CG (krylov_solve selects the PCG path in the KKT)
        opts2 = dataclasses.replace(opts, phase1_tol=0.0, krylov_solve=True)
    else:
        opts2 = dataclasses.replace(opts, factorization_dtype="",
                                    phase1_tol=0.0)
    return opts1, opts2


def measure_sparse_ls(kkt, prob, final, lb, ub, reps=3):
    """Measured cumulative factorize+backsolve seconds at the terminal
    iterate, scaled by the recorded counts — the sparse-driver analog of
    the dense driver's _measure_linear_solver (reference
    linear_solver_time, scripts/benchmarks_cpu.jl:55).

    Inside one jitted dispatch per-iteration timing is unobservable, so
    this times ONE factorization and ONE backsolve at the final state
    and multiplies by final.n_fact / final.n_solve.  For two-phase
    solves call it once per phase with that phase's KKT and terminal
    state and sum.  The jits are cached on the KKT object (pattern-keyed
    kernels are shared across same-pattern instances, so repeats pay no
    retrace)."""
    import time

    import jax

    from ..ops import kernels as K

    dev_idx = kkt.device_idx() if hasattr(kkt, "device_idx") else None
    if dev_idx is not None and hasattr(prob, "_replace"):
        prob = prob._replace(idx=dev_idx)

    jits = getattr(kkt, "_measure_jits", None)
    if jits is None:

        def fact(p, x, zl, zu, lb, ub, dw, dc):
            pr = K.sigma_diagonal(x, lb, ub, p.has_lb, p.has_ub, zl, zu, dw)
            f = kkt.factorize(p, pr, dc)
            return f, kkt.factor_ok(f)

        jits = (jax.jit(fact), jax.jit(kkt.solve))
        kkt._measure_jits = jits
    fact_jit, solve_jit = jits

    def best_of(fn, args, probe):
        best = float("inf")
        out = None
        for i in range(reps + 1):  # rep 0 is the compile/warm pass
            t0 = time.time()
            out = fn(*args)
            jax.device_get(probe(out))
            if i > 0:
                best = min(best, time.time() - t0)
        return best, out

    t_fact, (factors, _ok) = best_of(
        fact_jit,
        (prob, final.x, final.zl, final.zu, lb, ub, final.del_w,
         final.del_c),
        lambda out: out[1],
    )
    t_solve, _ = best_of(
        solve_jit, (factors, final.x, final.y), lambda out: out[1][:1])
    return t_fact * int(final.n_fact) + t_solve * int(final.n_solve)
