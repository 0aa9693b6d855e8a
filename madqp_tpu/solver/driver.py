"""User-facing solver driver: MPCSolver + solve().

Equivalent of the reference's `MPCSolver(nlp; kwargs...)` constructor
(src/structure.jl:77-176) and `solve!` driver (src/solver.jl:347-403):
banner, initialization, MPC loop, exception -> status taxonomy, timing,
summary print and stats object.
"""

from __future__ import annotations

import time
import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..models.qp import QuadraticProblem, build_standard_form
from ..utils import (
    ExecutionStats,
    Counters,
    MadLogger,
    MadQPError,
    Status,
    get_status_output,
    load_options,
)
from ..utils.logger import INFO
from ..utils.options import IPMOptions, KKTSystem
from . import state as S
from .certificates import certify_exit_status
from .mpc import MPCKernel

_STATUS_MAP = {
    S.SUCCESS: Status.SOLVE_SUCCEEDED,
    S.MAX_ITER: Status.MAXIMUM_ITERATIONS_EXCEEDED,
    S.STEP_ERROR: Status.ERROR_IN_STEP_COMPUTATION,
    S.DIVERGED: Status.DIVERGING_ITERATES,
    S.STALLED: Status.SOLVED_TO_ACCEPTABLE_LEVEL,
    S.RUNNING: Status.REGULAR,
}


import functools


@functools.lru_cache(maxsize=64)
def _jitted_kernel(opts: IPMOptions):
    """Cache (kernel, jitted fns) by options so solver instances with the
    same configuration share jit traces — combined with shape bucketing
    (pad_mode) this makes ragged suites reuse compiled executables."""
    kernel = MPCKernel(opts)
    return {
        "kernel": kernel,
        "solve": jax.jit(kernel.solve_from),
        "iter": jax.jit(kernel.iteration),
        "init": jax.jit(kernel.init_state),
        "warm_solve": jax.jit(kernel.solve_from_warm),
        "warm_init": jax.jit(kernel.init_state_warm),
    }


class MPCSolver:
    """Mehrotra predictor-corrector interior-point solver for LP/QP."""

    def __init__(self, qp: QuadraticProblem, **kwargs):
        self.qp = qp
        opts, ignored = load_options(**kwargs)
        self.opts = opts
        self.logger = MadLogger(
            print_level=opts.print_level,
            file_print_level=opts.file_print_level,
            output_file=opts.output_file,
        )
        if ignored:
            self.logger.print_ignored_options(ignored)

        if opts.kkt_system == KKTSystem.NORMAL and not qp.is_lp:
            raise ValueError(
                "NormalKKT supports only linear programs "
                "(reference normalkkt.jl:45-48)."
            )
        if opts.kkt_system == "schur":
            raise ValueError(
                "kkt_system='schur' requires a block-angular TwoStageProblem;"
                " use madqp_tpu.parallel.solve_two_stage instead."
            )
        if opts.kkt_system == "sparse-normal" and not qp.is_lp:
            # Beyond the reference (normalkkt.jl:45-48 rejects all QPs):
            # a diagonal Hessian keeps W = H + Σ diagonal, so the normal
            # equations still apply (see DeviceSparseNormalKKT).
            Hcoo = sp.coo_matrix(qp.H)
            if not (Hcoo.row == Hcoo.col).all():
                raise ValueError(
                    "sparse-normal KKT supports linear programs and "
                    "diagonal-Hessian QPs; use sparse-augmented."
                )

        # Construction-time numeric errors (e.g. too few degrees of
        # freedom) surface as a terminal status from solve(), matching the
        # reference's exception -> status taxonomy (src/solver.jl:379-380)
        # rather than escaping the constructor.
        self._construct_error = None

        self._sparse = opts.kkt_system in ("sparse-normal", "sparse-augmented")
        if self._sparse:
            try:
                self._init_sparse(qp, opts)
            except MadQPError as e:
                self._construct_error = e
                self.cnt = Counters(start_time=time.time(), init_time=0.0)
                if opts.rethrow_error:
                    raise
            return

        t0 = time.time()
        try:
            self.std, self.info, x0_int, y0_int = build_standard_form(
                qp, scaling=opts.scaling, max_gradient=opts.max_gradient,
                fixed_variable_treatment=opts.fixed_variable_treatment,
                bound_relax_factor=opts.bound_relax_factor,
            )
        except MadQPError as e:
            self._construct_error = e
            self.cnt = Counters(start_time=t0, init_time=time.time() - t0)
            if opts.rethrow_error:
                raise
            return
        if opts.pad_mode == "bucket":
            # Pad to power-of-two shape buckets so ragged suites share
            # compiled executables (stats recovery slices back via info).
            from ..parallel.batched import pad_standard

            def bucket(v, lo=32):
                b = lo
                while b < v:
                    b *= 2
                return b

            m_tot = bucket(self.std.m) if self.std.m else 0
            n_tot = bucket(self.std.n + (m_tot - self.std.m))
            self.std, x0_int, y0_int = pad_standard(
                self.std, x0_int, y0_int, n_tot, m_tot,
                force_H=self.std.H is not None,
            )
        dtype = jnp.dtype(opts.dtype)
        self.prob, lb, ub = S.problem_to_device(self.std, dtype)
        self._lb0, self._ub0 = lb, ub
        self._x0 = jnp.asarray(x0_int, dtype)
        self._y0 = jnp.asarray(y0_int, dtype)

        self._bind_kernel(opts)
        self._warm_point = None
        self.cnt = Counters(start_time=t0, init_time=time.time() - t0)

    def _init_sparse(self, qp, opts):
        """Sparse device KKTs: COO problem arrays + supernodal symbolic
        (pattern-specific, so the jitted kernel is bound per instance,
        not through the options-keyed cache)."""
        from ..models.qp import build_standard_form_sparse
        from .sparse_common import (canonical_coo_vals, get_sparse_kernel,
                                    pattern_fingerprint)
        from .sparse_lp import DeviceSparseNormalKKT, SparseLPProblem
        from .sparse_qp import DeviceSparseAugmentedKKT, SparseQPProblem

        t0 = time.time()
        self.std, self.info, x0_int, y0_int = build_standard_form_sparse(
            qp, scaling=opts.scaling, max_gradient=opts.max_gradient,
            fixed_variable_treatment=opts.fixed_variable_treatment,
            bound_relax_factor=opts.bound_relax_factor,
        )
        dtype = jnp.dtype(opts.dtype)
        fact_dtype = opts.factorization_dtype or None
        inverse = opts.solve_mode == "inverse"
        if opts.kkt_system == "sparse-normal":
            self._sparse_kind = "lp:auto:batched"
            self._sparse_fp = pattern_fingerprint(self.std.A, self.std.H)
            self._sparse_make = lambda: DeviceSparseNormalKKT(
                self.std.A, fact_dtype=fact_dtype, inverse=inverse,
            )
            self._sparse_make_f64 = lambda: DeviceSparseNormalKKT(
                self.std.A, fact_dtype=None, inverse=inverse,
            )
            # Krylov endgame (endgame="krylov"): f32 factor kept as the
            # PCG preconditioner; only matvecs run in f64.
            self._sparse_make_krylov = lambda: DeviceSparseNormalKKT(
                self.std.A, fact_dtype=fact_dtype, inverse=inverse,
                krylov=True, krylov_tol=opts.krylov_tol,
                krylov_maxit=opts.krylov_maxit,
            )
            kkt, kernel, jits = get_sparse_kernel(
                self._sparse_kind, self._sparse_fp, opts, self._sparse_make)
            base = dict(
                c0=jnp.asarray(self.std.c0, dtype),
                c=jnp.asarray(self.std.c, dtype),
                b=jnp.asarray(self.std.b, dtype),
                has_lb=jnp.asarray(self.std.has_lb),
                has_ub=jnp.asarray(self.std.has_ub),
                a_rows=jnp.asarray(kkt.coo_rows),
                a_cols=jnp.asarray(kkt.coo_cols),
                a_vals=jnp.asarray(canonical_coo_vals(self.std.A), dtype),
            )
            if self.std.H is not None and self.std.H.nnz:
                # diagonal-Hessian QP (validated in __init__): the H
                # diagonal rides into W through the traced arrays.
                from .sparse_common import canonical_csc

                Hcoo = canonical_csc(self.std.H).tocoo()
                self.prob = SparseQPProblem(
                    **base,
                    h_rows=jnp.asarray(Hcoo.row.astype(np.int32)),
                    h_cols=jnp.asarray(Hcoo.col.astype(np.int32)),
                    h_vals=jnp.asarray(
                        canonical_coo_vals(self.std.H), dtype),
                )
            else:
                self.prob = SparseLPProblem(**base)
        else:
            self._sparse_kind = "qp:auto"
            self._sparse_fp = pattern_fingerprint(self.std.A, self.std.H)
            self._sparse_make = lambda: DeviceSparseAugmentedKKT(
                self.std.H, self.std.A, fact_dtype=fact_dtype,
                inverse=inverse,
            )
            self._sparse_make_f64 = lambda: DeviceSparseAugmentedKKT(
                self.std.H, self.std.A, fact_dtype=None, inverse=inverse,
            )
            # PCG needs an SPD reduced system; the quasi-definite augmented
            # KKT has none, so the krylov endgame falls back to f64 here.
            self._sparse_make_krylov = None
            kkt, kernel, jits = get_sparse_kernel(
                self._sparse_kind, self._sparse_fp, opts, self._sparse_make)
            if kkt.H is not None:
                Hcoo = kkt.H.tocoo()
                h = (jnp.asarray(Hcoo.row.astype(np.int32)),
                     jnp.asarray(Hcoo.col.astype(np.int32)),
                     jnp.asarray(canonical_coo_vals(self.std.H), dtype))
            else:
                h = (jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32),
                     jnp.zeros((0,), dtype))
            self.prob = SparseQPProblem(
                c0=jnp.asarray(self.std.c0, dtype),
                c=jnp.asarray(self.std.c, dtype),
                b=jnp.asarray(self.std.b, dtype),
                has_lb=jnp.asarray(self.std.has_lb),
                has_ub=jnp.asarray(self.std.has_ub),
                a_rows=jnp.asarray(kkt.coo_rows),
                a_cols=jnp.asarray(kkt.coo_cols),
                a_vals=jnp.asarray(canonical_coo_vals(self.std.A), dtype),
                h_rows=h[0], h_cols=h[1], h_vals=h[2],
            )
        self._sparse_kkt = kkt
        self._sparse_cfg = (opts.factorization_dtype, opts.solve_mode)
        self._lb0 = jnp.asarray(self.std.lb, dtype)
        self._ub0 = jnp.asarray(self.std.ub, dtype)
        self._x0 = jnp.asarray(x0_int, dtype)
        self._y0 = jnp.asarray(y0_int, dtype)
        self._bind_kernel(opts)
        self._warm_point = None
        self.cnt = Counters(start_time=t0, init_time=time.time() - t0)

    def _bind_kernel(self, opts):
        if getattr(self, "_sparse", False):
            if (opts.factorization_dtype, opts.solve_mode) != self._sparse_cfg:
                # precision/backsolve-mode overrides at solve() time change
                # the KKT's numeric plan — rebuild it on the same pattern
                self._init_sparse(self.qp, opts)
                return
            # Pattern-cached kernel + jits: one trace serves every
            # same-pattern instance; solve-time option overrides re-key
            # the cache (opts is part of the key).
            from .sparse_common import get_sparse_kernel

            two_phase = (opts.factorization_dtype == "float32"
                         and opts.precision_scheme == "two-phase"
                         and opts.tol < opts.phase1_tol)
            if two_phase:
                # f32 kernel to phase1_tol, then a warm-started f64
                # endgame (see solver/sparse_lp.py for the rationale).
                # The python/verbose loop chains the same two phases
                # host-side via self._phase2.
                import dataclasses as _dc

                from .sparse_common import two_phase_opts

                opts1, opts2 = two_phase_opts(opts)
                make2 = self._sparse_make_f64
                if opts2.krylov_solve:
                    if self._sparse_make_krylov is None:
                        opts2 = _dc.replace(opts2, krylov_solve=False,
                                            factorization_dtype="")
                    else:
                        make2 = self._sparse_make_krylov
                kkt, kernel, jits1 = get_sparse_kernel(
                    self._sparse_kind, self._sparse_fp, opts1,
                    self._sparse_make)
                _, _, jits2 = get_sparse_kernel(
                    self._sparse_kind, self._sparse_fp, opts2, make2)

                def _solve2(prob, x0, y0, lb, ub):
                    f1 = jits1["solve"](prob, x0, y0, lb, ub)
                    f2 = jits2["warm_solve"](prob, f1.x, f1.y,
                                             f1.zl, f1.zu, lb, ub)
                    return f2._replace(k=f1.k + f2.k)

                def _warm2(prob, x0, y0, zl0, zu0, lb, ub):
                    f1 = jits1["warm_solve"](prob, x0, y0, zl0, zu0, lb, ub)
                    f2 = jits2["warm_solve"](prob, f1.x, f1.y,
                                             f1.zl, f1.zu, lb, ub)
                    return f2._replace(k=f1.k + f2.k)

                self._sparse_kkt = kkt
                self.kernel = kernel
                self._solve_jit = _solve2
                self._iter_jit = jits1["iter"]
                self._init_jit = jits1["init"]
                self._warm_solve_jit = _warm2
                self._warm_init_jit = jits1["warm_init"]
                self._phase2 = (jits2["warm_init"], jits2["iter"])
                return
            kkt, kernel, jits = get_sparse_kernel(
                self._sparse_kind, self._sparse_fp, opts, self._sparse_make)
            self._sparse_kkt = kkt
            self.kernel = kernel
            self._solve_jit = jits["solve"]
            self._iter_jit = jits["iter"]
            self._init_jit = jits["init"]
            self._warm_solve_jit = jits["warm_solve"]
            self._warm_init_jit = jits["warm_init"]
            self._phase2 = None
            return
        self._phase2 = None
        self._phase2_mode = "always"
        rescue = (opts.factorization_dtype
                  and opts.factorization_dtype != opts.dtype
                  and opts.precision_scheme == "two-phase")
        if rescue:
            # Dense mixed precision usually reaches tol in pure f32+IR
            # (bounded element growth at these sizes), so
            # unlike the sparse paths the full-precision phase runs only
            # as a RESCUE: the f32 kernel runs to tol with stall detection
            # on, and a warm-started full-precision endgame is chained
            # only when it exits unconverged (stall / max_iter / step
            # error — e.g. rank-deficient A where the f32 condensed Schur
            # stalls at ~1e-5 feasibility while f64 solves).
            import dataclasses

            opts1 = dataclasses.replace(
                opts, stall_exit=opts.stall_exit if opts.stall_exit > 0
                else 5,
                max_iter=min(opts.max_iter, opts.phase1_max_iter))
            opts2 = dataclasses.replace(opts, factorization_dtype="")
            fns1 = _jitted_kernel(opts1)
            fns2 = _jitted_kernel(opts2)
            self.kernel = fns1["kernel"]
            self._iter_jit = fns1["iter"]
            self._init_jit = fns1["init"]
            self._warm_init_jit = fns1["warm_init"]
            self._phase2 = (fns2["warm_init"], fns2["iter"])
            self._phase2_mode = "rescue"

            def _solve_r(prob, x0, y0, lb, ub):
                f1 = fns1["solve"](prob, x0, y0, lb, ub)
                if int(f1.status) == S.SUCCESS:
                    return f1
                f2 = fns2["warm_solve"](prob, f1.x, f1.y, f1.zl, f1.zu,
                                        lb, ub)
                return f2._replace(k=f1.k + f2.k)

            def _warm_r(prob, x0, y0, zl0, zu0, lb, ub):
                f1 = fns1["warm_solve"](prob, x0, y0, zl0, zu0, lb, ub)
                if int(f1.status) == S.SUCCESS:
                    return f1
                f2 = fns2["warm_solve"](prob, f1.x, f1.y, f1.zl, f1.zu,
                                        lb, ub)
                return f2._replace(k=f1.k + f2.k)

            self._solve_jit = _solve_r
            self._warm_solve_jit = _warm_r
            return
        fns = _jitted_kernel(opts)
        self.kernel = fns["kernel"]
        self._solve_jit = fns["solve"]
        self._iter_jit = fns["iter"]
        self._init_jit = fns["init"]
        self._warm_solve_jit = fns["warm_solve"]
        self._warm_init_jit = fns["warm_init"]

    # ------------------------------------------------------------------

    def solve(self, **kwargs) -> ExecutionStats:
        """Run the solve (reference solve!, src/solver.jl:347-403)."""
        if self._construct_error is not None:
            status = self._construct_error.status
            self.logger.notice(f"EXIT: {get_status_output(status)}")
            nan = float("nan")
            empty = np.full(self.qp.nvar, nan)
            return ExecutionStats(
                status=status, objective=nan, solution=empty,
                constraints=np.full(self.qp.ncon, nan),
                multipliers=np.full(self.qp.ncon, nan),
                multipliers_L=empty, multipliers_U=empty,
                iter=0, counters=self.cnt, options=self.opts,
            )
        if kwargs:
            # Solve-time option overrides force a re-trace.
            opts, ignored = load_options(
                **{**_opts_dict(self.opts), **kwargs}
            )
            if ignored:
                self.logger.print_ignored_options(ignored)
            self.opts = opts
            self._bind_kernel(opts)

        cnt = self.cnt
        cnt.start_time = time.time()
        cnt.linear_solver_time = 0.0
        self._ls_measured = False
        fact = self.opts.factorization_dtype or self.opts.dtype
        self.logger.notice(
            f"This is MadQP-JAX, running with {self.kernel.kkt.name} KKT "
            f"({self.opts.linear_solver} backend, dtype={self.opts.dtype}, "
            f"factorization={fact})\n"
        )
        # Problem-statistics banner (reference print_init analog).
        info = self.info
        nlb = int(np.sum(self.std.has_lb))
        nub = int(np.sum(self.std.has_ub))
        self.logger.notice(
            f"Number of variables ............................: {info.nvar}\n"
            f"Number of constraints ..........................: {info.ncon}\n"
            f"Number of nonzeros in constraint Jacobian ......: {self.qp.nnzj}\n"
            f"Number of nonzeros in Lagrangian Hessian .......: {self.qp.nnzh}\n"
            f"Internal variables (incl. slacks / padding) ....: {self.std.n}\n"
            f"Variables with lower / upper bounds ............: {nlb} / {nub}\n"
        )
        status = Status.INTERNAL_ERROR
        final = None
        # Per-iteration logging requires host-driven stepping: ordered host
        # callbacks deadlock inside while_loop on the CPU backend, so a
        # verbose solve mirrors the reference's host-side print loop.
        use_python_loop = (
            self.opts.loop_mode == "python"
            # 'auto' = host-stepped on the pattern-specific sparse paths:
            # the while-loop wrapper costs far more XLA compile than the
            # iteration program it wraps (see options.loop_mode).
            or (self.opts.loop_mode == "auto"
                and getattr(self, "_sparse", False))
            or self.opts.print_level <= INFO
            # wall-time limits need host-side stepping: the jitted solve is
            # one uninterruptible XLA call
            or self.opts.max_wall_time < 1e6
        )
        self._walltime_exceeded = False
        try:
            warm = self._warm_point is not None
            if use_python_loop:
                final = self._run_python_loop()
            elif warm:
                x0, y0, zl0, zu0 = self._warm_point
                final = self._warm_solve_jit(
                    self.prob, x0, y0, zl0, zu0, self._lb0, self._ub0
                )
                jax.block_until_ready(final)
            else:
                final = self._solve_jit(
                    self.prob, self._x0, self._y0, self._lb0, self._ub0
                )
                jax.block_until_ready(final)
            if self._walltime_exceeded:
                status = Status.MAXIMUM_WALLTIME_EXCEEDED
            else:
                status = _STATUS_MAP.get(int(final.status), Status.INTERNAL_ERROR)
                # Non-convergence with diverging duals is how an IPM
                # manifests an empty feasible set, and diverging primals
                # an unbounded objective; upgrade to a *certified* status
                # when the terminal direction is a Farkas certificate /
                # descent ray.  (The reference has no infeasible/unbounded
                # statuses — SURVEY §4.)
                status = certify_exit_status(
                    self.std, np.asarray(final.x), np.asarray(final.y),
                    status)
        except MadQPError as e:
            status = e.status
            if self.opts.rethrow_error:
                raise
        finally:
            cnt.total_time = time.time() - cnt.start_time
            if (self.opts.measure_linear_solver and final is not None
                    and not self._ls_measured):
                # jit-loop path: extrapolate from timed factorize/backsolve
                # at the terminal iterate (the python loop accumulates
                # per-iterate measurements instead).
                try:
                    cnt.linear_solver_time = self._measure_linear_solver(final)
                except Exception:
                    pass  # measurement is best-effort; never fail the solve
            if final is not None:
                # Reference print_summary (src/solver.jl:394), before EXIT.
                sign = 1.0 if self.info.minimize else -1.0
                self.logger.print_summary(
                    iter=int(final.k),
                    objective=sign * float(final.obj_val) / self.info.obj_scale,
                    objective_scaled=float(final.obj_val),
                    inf_pr=float(final.inf_pr),
                    inf_du=float(final.inf_du),
                    inf_compl=float(final.inf_compl),
                    total_time=cnt.total_time,
                    init_time=cnt.init_time,
                    linear_solver_time=(
                        cnt.linear_solver_time
                        if self.opts.measure_linear_solver else -1.0),
                    factorizations=int(final.n_fact),
                    backsolves=int(final.n_solve),
                )
            self.logger.notice(f"EXIT: {get_status_output(status)}")

        return self._build_stats(final, status)

    def _measure_jits(self):
        """Timed factorize/backsolve measurers.

        Each jit returns (result, probe) where probe is a scalar reduction
        over every output leaf: fetching it with device_get both
        synchronizes and defeats XLA dead-code elimination of the
        un-fetched outputs.

        Cached on the (options-shared) kernel with the problem passed as an
        ARGUMENT: same-bucket instances reuse the compiled measurers
        instead of retracing per solve (fresh jit objects closing over the
        problem bake it in as constants and recompile per instance)."""
        kern = self.kernel
        cached = getattr(kern, "_measure_jits", None)
        if cached is not None:
            return cached

        def probe(tree):
            s = jnp.zeros((), jnp.float32)
            for leaf in jax.tree_util.tree_leaves(tree):
                s = s + jnp.sum(leaf).astype(jnp.float32)
            return s

        def fact_fn(prob, x, zl, zu, lb, ub, dw, dc):
            factors = kern._factorize(prob, x, lb, ub, zl, zu, dw, dc)[0]
            return factors, probe(factors)

        def solve_fn(f, rx, ry):
            out = kern.kkt.solve(f, rx, ry)
            return out, probe(out)

        cached = (jax.jit(fact_fn), jax.jit(solve_fn))
        kern._measure_jits = cached
        return cached

    def _measure_at(self, st, reps=2):
        """Measured wall seconds of (one factorization, one backsolve) at
        iterate `st` (best of reps)."""
        fact_jit, solve_jit = self._measure_jits()
        p = self.prob

        def best_of(fn, *args):
            best = float("inf")
            for _ in range(reps):
                t0 = time.time()
                out = fn(*args)
                jax.device_get(out[1])  # sync on the scalar probe
                best = min(best, time.time() - t0)
            return best, out[0]

        t_fact, factors = best_of(
            fact_jit, p, st.x, st.zl, st.zu, st.lb, st.ub, st.del_w, st.del_c)
        t_solve, _ = best_of(solve_jit, factors, st.x, st.y)
        return t_fact, t_solve

    def _measure_linear_solver(self, final) -> float:
        """Estimate cumulative factorize+backsolve time (the reference's
        linear_solver_time, scripts/benchmarks_cpu.jl:55) for the jitted
        while_loop path, where per-iteration timing is unobservable: time
        one factorization and one backsolve at the terminal iterate and
        scale by the recorded counts.  The python loop path accumulates
        per-iterate measurements instead (see _run_python_loop)."""
        t_fact, t_solve = self._measure_at(final, reps=3)
        return t_fact * int(final.n_fact) + t_solve * int(final.n_solve)

    def set_initial_point(self, x=None, y=None, zl=None, zu=None):
        """Supply a user-space warm-start point for the next solve().

        Maps user coordinates into the internal (scaled, slack-augmented)
        space — the inverse of the stats recovery.  Missing pieces default
        to the cold-start values / ones; slack bound duals derive from y.
        Call clear_initial_point() to return to cold starts.
        """
        info = self.info
        dtype = jnp.dtype(self.opts.dtype)
        n, m = info.n, info.m
        sign = 1.0 if info.minimize else -1.0
        s_rows = info.ineq_rows
        ns = len(s_rows)

        if x is not None:
            x = np.asarray(x, dtype=np.float64)
            x_kept = x[info.keep_idx]
            # Slack = con_scale * (A_kept @ x_kept): the fixed-variable
            # columns are eliminated from the internal rows (their shift
            # moved into b), so they must NOT contribute here.
            A_keep = self.qp.A[s_rows][:, info.keep_idx] if ns else None
            s0 = (
                info.con_scale[s_rows] * np.asarray(A_keep @ x_kept).ravel()
                if ns else np.zeros(0)
            )
            x_int = np.concatenate([x_kept, s0])
        else:
            x_int = np.asarray(self._x0, dtype=np.float64)[:n]
        if y is not None:
            y = np.asarray(y, dtype=np.float64)
            y_int = sign * y * info.obj_scale / np.maximum(info.con_scale, 1e-300)
        else:
            y_int = np.asarray(self._y0, dtype=np.float64)[:m]

        def z_int(z_user):
            # Inverse of recover_z (models/qp.py): z_int = sign*obj_scale*z.
            out = np.ones(n)
            if z_user is not None:
                z_user = np.asarray(z_user, dtype=np.float64)
                out[: info.n_kept] = sign * info.obj_scale * z_user[info.keep_idx]
            return out

        zl_int = z_int(zl)
        zu_int = z_int(zu)
        if ns:
            # Slack bound duals from dual feasibility of the slack column
            # (-y_i - zl_s + zu_s = 0): zl_s = max(-y, 0), zu_s = max(y, 0).
            ys = y_int[s_rows]
            zl_int[info.n_kept:] = np.maximum(-ys, 0.0)
            zu_int[info.n_kept:] = np.maximum(ys, 0.0)

        n_tot = self.prob.n  # may exceed info.n under pad_mode bucketing
        pad = lambda v, size, fill: np.concatenate(
            [v, np.full(size - len(v), fill)]
        ) if size > len(v) else v
        self._warm_point = (
            jnp.asarray(pad(x_int, n_tot, 0.0), dtype),
            jnp.asarray(pad(y_int, self.prob.m, 0.0), dtype),
            jnp.asarray(pad(zl_int, n_tot, 1.0), dtype),
            jnp.asarray(pad(zu_int, n_tot, 1.0), dtype),
        )
        return self

    def clear_initial_point(self):
        self._warm_point = None
        return self

    def _run_python_loop(self):
        """Host-driven stepping with the reference's 9-column iteration line
        (src/structure.jl:178-195).  The line for iterate k mixes the freshly
        computed residuals (stored by the iteration) with the *previous*
        step's mu, ||d||, regularization and step sizes — exactly matching
        the reference's print-before-step ordering."""
        verbose = self.opts.print_level <= INFO
        scale = self.info.obj_scale
        deadline = time.time() + self.opts.max_wall_time
        if self._warm_point is not None:
            x0, y0, zl0, zu0 = self._warm_point
            state = self._warm_init_jit(
                self.prob, x0, y0, zl0, zu0, self._lb0, self._ub0
            )
        else:
            state = self._init_jit(
                self.prob, self._x0, self._y0, self._lb0, self._ub0
            )
        measure = self.opts.measure_linear_solver
        if measure and (int(state.n_fact) or int(state.n_solve)):
            # starting-point factorization + 3 KKT solves (init_state)
            t_fact, t_solve = self._measure_at(state)
            self.cnt.linear_solver_time += (
                t_fact * int(state.n_fact) + t_solve * int(state.n_solve))
            self._ls_measured = True

        def run(iter_jit, state, k_off):
            while int(state.status) == S.RUNNING:
                if time.time() > deadline:
                    self._walltime_exceeded = True
                    return state
                prev = state
                state = iter_jit(self.prob, prev)
                if measure:
                    # True accumulation (vs the jit path's terminal-iterate
                    # extrapolation): measure one factorize and one
                    # backsolve at THIS iterate, scaled by this iteration's
                    # actual factorization/backsolve counts.
                    t_fact, t_solve = self._measure_at(prev)
                    self.cnt.linear_solver_time += (
                        t_fact * (int(state.n_fact) - int(prev.n_fact))
                        + t_solve * (int(state.n_solve) - int(prev.n_solve))
                    )
                    self._ls_measured = True
                if verbose and bool(prev.initialized):
                    # the first call computes the starting point (state.py
                    # `initialized`); the reference prints its first line at
                    # iter 0 AFTER initialize! (src/solver.jl:274)
                    self.logger.print_iter(
                        k_off + int(prev.k),
                        float(state.obj_val) / scale,
                        float(state.inf_pr),
                        float(state.inf_du),
                        float(prev.mu),
                        float(prev.d_norm),
                        float(prev.del_w),
                        float(prev.alpha_d),
                        float(prev.alpha_p),
                    )
            return state

        state = run(self._iter_jit, state, 0)
        if (getattr(self, "_phase2_mode", "always") == "rescue"
                and int(state.status) == S.SUCCESS):
            return state  # dense rescue mode: endgame only on failure
        if getattr(self, "_phase2", None) is not None \
                and not self._walltime_exceeded:
            # Two-phase mixed precision: chain the warm-started f64
            # endgame exactly like the jitted _solve2 path (which chains
            # unconditionally — a failed f32 phase still hands its best
            # iterate to the f64 kernel).
            warm_init2, iter2 = self._phase2
            k1 = int(state.k)
            if verbose:
                self.logger.notice(
                    f"Phase 1 (f32) done at iter {k1}; "
                    "switching to f64 endgame\n")
            state2 = warm_init2(self.prob, state.x, state.y,
                                state.zl, state.zu, self._lb0, self._ub0)
            state2 = run(iter2, state2, k1)
            state = state2._replace(k=state.k + state2.k)
        return state

    # ------------------------------------------------------------------

    def _build_stats(self, final, status: Status) -> ExecutionStats:
        info = self.info
        cnt = self.cnt
        if final is None:
            nan = float("nan")
            empty = np.full(info.nvar, nan)
            return ExecutionStats(
                status=status, objective=nan, solution=empty,
                constraints=np.full(info.ncon, nan), multipliers=np.full(info.ncon, nan),
                multipliers_L=empty, multipliers_U=empty,
                iter=0, counters=cnt, options=self.opts,
            )
        cnt.k = int(final.k)
        cnt.factorizations = int(final.n_fact)
        cnt.backsolves = int(final.n_solve)

        # Slice off any bucket padding (pad_mode): recovery uses the
        # original internal sizes recorded in TransformInfo.
        x_int = np.asarray(final.x, dtype=np.float64)[: info.n]
        y_int = np.asarray(final.y, dtype=np.float64)[: info.m]
        zl_int = np.asarray(final.zl, dtype=np.float64)[: info.n]
        zu_int = np.asarray(final.zu, dtype=np.float64)[: info.n]

        x_user = info.recover_x(x_int)
        y_user = info.recover_y(y_int)
        # Fixed variables report their reduced cost as bound multipliers.
        g_user = self.qp.grad(x_user)
        r_fix = g_user + self.qp.jtprod(y_user)
        zl_fill = np.maximum(r_fix, 0.0)
        zu_fill = np.maximum(-r_fix, 0.0)
        zl_user = info.recover_z(zl_int, zl_fill)
        zu_user = info.recover_z(zu_int, zu_fill)

        objective = self.qp.obj(x_user)
        constraints = self.qp.cons(x_user)

        return ExecutionStats(
            status=status,
            objective=float(objective),
            solution=x_user,
            constraints=constraints,
            multipliers=y_user,
            multipliers_L=zl_user,
            multipliers_U=zu_user,
            iter=int(final.k),
            counters=cnt,
            primal_feas=float(final.inf_pr),
            dual_feas=float(final.inf_du),
            complementarity=float(final.inf_compl),
            options=self.opts,
        )


def _opts_dict(opts: IPMOptions) -> dict:
    import dataclasses

    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}


def solve(qp: QuadraticProblem, **kwargs) -> ExecutionStats:
    """One-shot convenience: build an MPCSolver and run it."""
    return MPCSolver(qp, **kwargs).solve()


def autosolve(qp: QuadraticProblem, dense_limit: int = 1500,
              **kwargs) -> ExecutionStats:
    """Route to the best device path by problem shape.

    - small (internal dim <= dense_limit) or dense data -> the padded
      dense path (`solve`): at these sizes dense factorization beats
      sparse bookkeeping (SURVEY §7.1 "two regimes");
    - large + sparse -> the on-device supernodal sparse paths with
      `kkt_system="auto"` (LP/diagonal-H -> normal equations,
      inequality-dominated -> condensed K1, else augmented K2).

    The explicit entry points (`solve`, `solve_sparse_lp`,
    `solve_sparse_qp`, `solve_sparse_condensed`, `solve_host`) remain for
    callers who know their structure.
    """
    m, n = qp.A.shape
    # internal dimension after slacking every range/inequality row
    internal = n + m
    density = qp.A.nnz / max(1, m * n)
    nnz_h = qp.H.nnz if qp.H is not None else 0
    dense_h = qp.H is not None and nnz_h > 0.25 * n * n
    if internal <= dense_limit or density > 0.25 or dense_h:
        kwargs.setdefault("pad_mode", "bucket")
        if internal >= 2048:
            # Large genuinely-dense problems: the panel-Cholesky blocked
            # backend (factored inverse, matvec backsolves) replaces the
            # XLA cholesky + sequential-triangular-solve path.  The
            # threshold was set on earlier hardware and awaits a sweep.
            kwargs.setdefault("linear_solver", "blocked")
        return solve(qp, **kwargs)
    from .sparse_qp import solve_sparse_qp

    kwargs.pop("pad_mode", None)
    return solve_sparse_qp(qp, kkt_system="auto", **kwargs)
