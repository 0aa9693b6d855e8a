"""The Mehrotra predictor-corrector core as pure jittable functions.

Functional re-design of the reference's mpc! loop (src/solver.jl:188-345)
and starting point (src/solver.jl:6-125): one `iteration(prob, state) ->
state` containing factorization, predictor, barrier update, corrector,
optional Gondzio multi-corrections, step rule and iterate update — driven by
`lax.while_loop` so the entire solve is a single XLA computation with no
host round-trips (SURVEY §3.4: scalar decisions stay on device).

The problem data is an explicit argument (not closed-over state) so the same
kernel vmaps over batched problem pytrees and shards over a device mesh
(SURVEY §2.5: batched-instance data parallelism).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import kernels as K
from ..ops.kkt import make_kkt, kkt_mul
from ..utils.options import (
    IPMOptions,
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    MehrotraAdaptiveStep,
    NoRegularization,
)
from .state import (
    DIVERGED,
    IPMState,
    MAX_ITER,
    ProblemArrays,
    RUNNING,
    STALLED,
    STEP_ERROR,
    SUCCESS,
)

_MAX_FACT_TRIALS = 3      # reference src/linear_solver.jl:7
_REG_ESCALATION = 100.0   # reference src/linear_solver.jl:14-15
_GONDZIO_DELTA = 0.1      # reference src/solver.jl:201-205
_GONDZIO_BETA_MIN = 0.1
_GONDZIO_BETA_MAX = 10.0
_GONDZIO_TAU = 0.995
_GONDZIO_ACCEPT = 1.005   # reference src/solver.jl:241


def _tree_select(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _full_precision(fn):
    """Trace `fn` with every f32 matrix product at full f32 precision.

    On GPUs with tensor cores an f32 product at default precision may run in
    TF32 (about three decimal digits), which stalls an f32 factorization
    plus f64 refinement short of tol.  Applied to every public entry point
    of MPCKernel, so each trace of the solver carries HIGHEST on its dots."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


class MPCKernel:
    """Traced MPC solver: static options + pure methods over problem pytrees."""

    def __init__(self, opts: IPMOptions, kkt=None):
        self.opts = opts
        fact_dtype = opts.factorization_dtype or None
        self.kkt = kkt if kkt is not None else make_kkt(
            opts.kkt_system, fact_dtype=fact_dtype,
            chol_backend=("blocked" if opts.linear_solver == "blocked"
                          else "xla"),
            solve_mode=opts.solve_mode,
        )
        self.dtype = jnp.dtype(opts.dtype)
        self.eps = float(jnp.finfo(self.dtype).eps)

    # -- model callbacks (dense; reference L3 eval wrappers) ----------------

    def objective(self, p, x):
        val = p.c0 + jnp.dot(p.c, x)
        if not p.is_lp:
            val = val + 0.5 * jnp.dot(x, p.hess_mv(x))
        return val

    def gradient(self, p, x):
        return p.c if p.is_lp else p.c + p.hess_mv(x)

    def cons_residual(self, p, x):
        return p.jac_mv(x) - p.b

    def jtprod(self, p, y):
        return p.jac_rmv(y)

    # -- linear algebra -----------------------------------------------------

    def _factorize(self, p, x, lb, ub, zl, zu, del_w, del_c):
        pr_diag = K.sigma_diagonal(x, lb, ub, p.has_lb, p.has_ub, zl, zu, del_w)
        f = self.kkt.factorize(p, pr_diag, del_c)
        return f, self.kkt.factor_ok(f)

    def _retry_loop(self, make_factors, del_w, del_c):
        """Factorize; on failure escalate both regularizations by 100x, up
        to 3 trials (reference factorize_regularized_system!).  Zero
        regularization is seeded with a small nonzero so singular KKT
        systems (e.g. rank-deficient A) still factor.

        The factorization is traced ONCE (inside the while body, which also
        performs the initial trial): on the sparse supernodal paths one
        factorization walk costs seconds of lower+compile, so trace count
        directly sets the compile bill.  The
        initial factor carry is a zeros pytree from eval_shape — never
        observable, the body always overwrites it on trial 0."""
        dw0 = jnp.asarray(del_w, self.dtype)
        dc0 = jnp.asarray(del_c, self.dtype)
        shapes = jax.eval_shape(make_factors, dw0, dc0)
        f_init = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes[0]
        )

        def cond(carry):
            trial, _, _, _, ok = carry
            # trial 0 is the unescalated attempt; 3 attempts total, same
            # as the previous initial-call + 2-retry structure.
            return jnp.logical_and(~ok, trial < _MAX_FACT_TRIALS)

        def body(carry):
            trial, dw, dc, _, _ = carry
            esc_w = jnp.where(dw != 0.0, dw * _REG_ESCALATION, 1e-8)
            esc_c = jnp.where(dc != 0.0, dc * _REG_ESCALATION, -1e-8)
            dw = jnp.where(trial == 0, dw, esc_w)
            dc = jnp.where(trial == 0, dc, esc_c)
            f, ok = make_factors(dw, dc)
            return (trial + 1, dw, dc, f, ok)

        trial, dw, dc, f, ok = lax.while_loop(
            cond, body,
            (jnp.int32(0), dw0, dc0, f_init, jnp.asarray(False)),
        )
        return f, dw, dc, ok

    def factorize_with_retry(self, p, x, lb, ub, zl, zu, del_w, del_c):
        return self._retry_loop(
            lambda dw, dc: self._factorize(p, x, lb, ub, zl, zu, dw, dc),
            del_w, del_c,
        )

    def solve_system(self, p, factors, p_rhs, x, lb, ub, zl, zu, del_w, del_c):
        """Unreduced KKT solve + residual check
        (reference solve_system!, src/linear_solver.jl:19-45).

        Returns (d, ok): ok is False when the residual ratio is NaN, or —
        with check_residual — exceeds tol_linear_solve.
        """
        masks = (p.has_lb, p.has_ub)

        def backsolve(rhs):
            rx, ry = K.reduce_rhs(rhs, x, lb, ub, *masks)
            dx, dy = self.kkt.solve(factors, rx, ry)
            dzl, dzu = K.recover_bound_duals(rhs, dx, x, lb, ub, *masks, zl, zu)
            return K.KKTVec(x=dx, y=dy, zl=dzl, zu=dzu)

        def residual(d):
            Kd = kkt_mul(p, del_w, del_c, x, lb, ub, *masks, zl, zu, d)
            return jax.tree.map(lambda a, b: a - b, p_rhs, Kd)

        # One backsolve TRACE regardless of refinement depth: start from
        # d = 0 (residual(0) == p_rhs, so step 0 is the plain backsolve)
        # and run 1 + max_refine_steps correction steps under lax.scan —
        # on the sparse supernodal paths each traced backsolve walk costs
        # seconds of compile.
        def refine_step(d, _):
            d = jax.tree.map(lambda a, b: a + b, d, backsolve(residual(d)))
            return d, None

        d0 = jax.tree.map(jnp.zeros_like, p_rhs)
        d, _ = lax.scan(refine_step, d0, None,
                        length=1 + self.opts.max_refine_steps)

        w = residual(d)
        ratio = w.flat_inf_norm() / jnp.maximum(1.0, p_rhs.flat_inf_norm())
        ok = ~jnp.isnan(ratio)
        if self.opts.check_residual:
            ok = ok & (ratio <= self.opts.tol_linear_solve)
        return d, ok

    # -- regularization policy (src/kernels.jl:380-417) ---------------------

    def _init_regularization(self):
        reg = self.opts.regularization
        one = jnp.asarray(1.0, self.dtype)
        zero = jnp.asarray(0.0, self.dtype)
        if isinstance(reg, NoRegularization):
            return one, zero, zero, zero
        dd = jnp.asarray(reg.delta_d, self.dtype)
        dp = jnp.asarray(reg.delta_p, self.dtype)
        return one, dd, dp, dd

    def _update_regularization(self, state: IPMState):
        reg = self.opts.regularization
        if isinstance(reg, NoRegularization):
            zero = jnp.asarray(0.0, self.dtype)
            return zero, zero, state.reg_p, state.reg_d
        if isinstance(reg, FixedRegularization):
            return (
                jnp.asarray(reg.delta_p, self.dtype),
                jnp.asarray(reg.delta_d, self.dtype),
                state.reg_p,
                state.reg_d,
            )
        assert isinstance(reg, AdaptiveRegularization)
        new_p = jnp.maximum(state.reg_p / 10.0, reg.delta_min)
        new_d = jnp.minimum(state.reg_d / 10.0, -reg.delta_min)
        return new_p, new_d, new_p, new_d

    # -- step rule (src/kernels.jl:307-374) ----------------------------------

    def _step_rule(self, p, d, x, lb, ub, zl, zu, mu):
        rule = self.opts.step_rule
        args = (d, x, lb, ub, p.has_lb, p.has_ub, zl, zu)
        if isinstance(rule, ConservativeStep):
            return K.fraction_to_boundary(*args, rule.tau)
        if isinstance(rule, AdaptiveStep):
            tau = jnp.maximum(1.0 - mu, rule.tau_min)
            return K.fraction_to_boundary(*args, tau)
        assert isinstance(rule, MehrotraAdaptiveStep)
        return K.step_mehrotra_adaptive(
            d, x, lb, ub, p.has_lb, p.has_ub, zl, zu, mu, rule.gamma_f
        )

    # -- fused direction computation ------------------------------------------
    #
    # Predictor, Mehrotra corrector, and the Gondzio multi-corrections
    # (reference src/solver.jl:200-251,294-324) all consist of "build a
    # phase-specific RHS, run one KKT backsolve, fold the result into the
    # direction".  They are fused into ONE lax.scan whose body contains the
    # single traced backsolve walk: on the sparse supernodal paths each
    # traced walk costs seconds of XLA compile, so the per-iteration walk
    # count directly sets the cold-compile bill.  The phase-specific
    # elementwise work (RHS builders, ratio tests, accept logic) lives in
    # lax.switch branches — cheap to trace, scalar-free to run.

    def _direction_scan(self, p, factors, g, jacl, c_res, mu_curr, n_bounded,
                        x, lb, ub, zl, zu, del_w, del_c,
                        initialized):
        """Returns (d, mu_new, failed): the search direction after predictor
        + corrector + max_ncorr Gondzio corrections, the updated barrier,
        and the accumulated hard-failure flag.  With initialized == False
        the scan instead runs the two starting-point least-squares solves
        (phases 2/3) through the same traced backsolve."""
        masks = (p.has_lb, p.has_ub)
        opt = self.opts
        bar = opt.barrier_update
        zero = jnp.asarray(0.0, self.dtype)
        zero_n = jnp.zeros(p.n, self.dtype)
        d0 = K.KKTVec(x=zero_n, y=jnp.zeros(p.m, self.dtype),
                      zl=zero_n, zu=zero_n)

        # Pre-solve branches: carry -> (rhs, cand_lb, cand_ub, mu_new).
        def pre_predictor(c):
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            rhs = K.predictor_rhs(g, jacl, c_res, x, lb, ub, *masks, zl, zu)
            return rhs, corr_lb, corr_ub, mu_new

        def pre_corrector(c):
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            a_aff_p, a_aff_d = K.fraction_to_boundary(
                d, x, lb, ub, *masks, zl, zu, 1.0
            )
            mu_aff = K.affine_complementarity_measure(
                d, x, lb, ub, *masks, zl, zu, a_aff_p, a_aff_d
            )
            cand_lb, cand_ub = K.mehrotra_correction(d, *masks)
            mu = K.mehrotra_barrier(
                mu_curr, mu_aff, n_bounded, opt.mu_min,
                bar.sigma_min, bar.sigma_max,
            )
            rhs = K.correction_rhs(
                g, jacl, c_res, x, lb, ub, *masks, zl, zu, mu, cand_lb, cand_ub
            )
            return rhs, cand_lb, cand_ub, mu

        def pre_gondzio(c):
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            tilde_p = jnp.minimum(a_p + _GONDZIO_DELTA, 1.0)
            tilde_d = jnp.minimum(a_d + _GONDZIO_DELTA, 1.0)
            ga = K.affine_complementarity_measure(
                d, x, lb, ub, *masks, zl, zu, tilde_p, tilde_d
            )
            mu_g = (ga / jnp.maximum(mu_curr, 1e-300)) ** 2 * ga  # Eq. (12)
            cand_lb, cand_ub = K.gondzio_extra_correction(
                d, x, lb, ub, *masks, zl, zu, corr_lb, corr_ub,
                tilde_p, tilde_d, _GONDZIO_BETA_MIN, _GONDZIO_BETA_MAX, mu_g,
            )
            rhs = K.correction_rhs(
                g, jacl, c_res, x, lb, ub, *masks, zl, zu, mu_g,
                cand_lb, cand_ub,
            )
            return rhs, cand_lb, cand_ub, mu_new

        # Post-solve branches: fold d_new into the carry.
        def post_predictor(args):
            c, cand_lb, cand_ub, mu, d_new, ok = args
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            return (d_new, corr_lb, corr_ub, mu_new, a_p, a_d, active,
                    failed | ~ok)

        def post_corrector(args):
            c, cand_lb, cand_ub, mu, d_new, ok = args
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            # Seed the Gondzio loop's running step lengths.
            a_p, a_d = K.fraction_to_boundary(
                d_new, x, lb, ub, *masks, zl, zu, _GONDZIO_TAU
            )
            return (d_new, cand_lb, cand_ub, mu, a_p, a_d, active,
                    failed | ~ok)

        def post_gondzio(args):
            c, cand_lb, cand_ub, mu, d_new, ok = args
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            hat_p, hat_d = K.fraction_to_boundary(
                d_new, x, lb, ub, *masks, zl, zu, _GONDZIO_TAU
            )
            accept = (
                (hat_p >= _GONDZIO_ACCEPT * a_p)
                & (hat_d >= _GONDZIO_ACCEPT * a_d)
                & active
            )
            failed = failed | (active & ~ok)
            d = _tree_select(accept, d_new, d)
            corr_lb = jnp.where(accept, cand_lb, corr_lb)
            corr_ub = jnp.where(accept, cand_ub, corr_ub)
            a_p = jnp.where(accept, hat_p, a_p)
            a_d = jnp.where(accept, hat_d, a_d)
            return (d, corr_lb, corr_ub, mu_new, a_p, a_d, accept, failed)

        # Starting-point phases (reference src/solver.jl:6-33), run by the
        # FIRST iteration call (state.initialized == False) through the same
        # scanned backsolve.  With zl = zu = 0 (the uninitialized state) the
        # unreduced KKT degenerates exactly to the del_w-regularized
        # least-squares system the reference factorizes for its starting
        # point, so reduce_rhs/recover_bound_duals/kkt_mul are all
        # consistent and refinement remains valid.
        def pre_init_primal(c):
            # rhs = (0, -c_res, 0, 0): primal least squares.
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            rhs = K.initial_primal_rhs(c_res, p.n, self.dtype)
            return rhs, corr_lb, corr_ub, mu_new

        def pre_init_dual(c):
            # rhs = (-g, 0, 0, 0): dual least squares.
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            rhs = K.initial_dual_rhs(g, p.m, self.dtype)
            return rhs, corr_lb, corr_ub, mu_new

        def post_init_primal(args):
            c, cand_lb, cand_ub, mu, d_new, ok = args
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            return (d._replace(x=d_new.x), corr_lb, corr_ub, mu_new,
                    a_p, a_d, active, failed)

        def post_init_dual(args):
            c, cand_lb, cand_ub, mu, d_new, ok = args
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            return (d._replace(y=d_new.y), corr_lb, corr_ub, mu_new,
                    a_p, a_d, active, failed)

        def pre_noop(c):
            d, corr_lb, corr_ub, mu_new, a_p, a_d, active, failed = c
            return d0, corr_lb, corr_ub, mu_new

        def post_noop(args):
            c, *_ = args
            return c

        pres = [pre_predictor, pre_corrector, pre_init_primal, pre_init_dual]
        posts = [post_predictor, post_corrector, post_init_primal,
                 post_init_dual]
        norm_ph = [0, 1]
        init_ph = [2, 3]
        if opt.max_ncorr > 0:
            pres += [pre_gondzio, pre_noop]
            posts += [post_gondzio, post_noop]
            norm_ph += [4] * opt.max_ncorr
            init_ph += [5] * opt.max_ncorr

        def step(carry, phase):
            rhs, cand_lb, cand_ub, mu = lax.switch(phase, pres, carry)
            d_new, ok = self.solve_system(
                p, factors, rhs, x, lb, ub, zl, zu, del_w, del_c
            )
            carry = lax.switch(
                phase, posts, (carry, cand_lb, cand_ub, mu, d_new, ok)
            )
            return carry, None

        phases = jnp.where(
            initialized,
            jnp.asarray(norm_ph, jnp.int32),
            jnp.asarray(init_ph, jnp.int32),
        )
        carry0 = (d0, zero_n, zero_n, mu_curr, zero, zero,
                  jnp.asarray(True), jnp.asarray(False))
        carry, _ = lax.scan(step, carry0, phases)
        d, _, _, mu_new, _, _, _, failed = carry
        return d, mu_new, failed

    # -- one MPC iteration (src/solver.jl:254-344) ---------------------------

    @_full_precision
    def iteration(self, p: ProblemArrays, state: IPMState) -> IPMState:
        masks = (p.has_lb, p.has_ub)
        x, y, zl, zu, lb, ub = state.x, state.y, state.zl, state.zu, state.lb, state.ub

        g = self.gradient(p, x)
        c_res = self.cons_residual(p, x)
        jacl = self.jtprod(p, y)

        obj = self.objective(p, x)
        inf_pr = K.primal_infeasibility(c_res) / jnp.maximum(1.0, state.norm_b)
        inf_du = K.dual_infeasibility(g, jacl, zl, zu) / jnp.maximum(
            1.0, state.norm_c
        )
        inf_compl = K.optimality_gap(x, lb, ub, *masks, zl, zu) / jnp.maximum(
            1.0, state.norm_c
        )
        state = state._replace(
            obj_val=obj, inf_pr=inf_pr, inf_du=inf_du, inf_compl=inf_compl
        )

        # NOTE: per-iteration logging happens host-side in the driver's
        # python-stepped loop; ordered host callbacks deadlock inside
        # while_loop on the CPU backend.

        worst = jnp.maximum(jnp.maximum(inf_pr, inf_du), inf_compl)
        initialized = state.initialized
        # Infeasibility signature (a detection the reference lacks,
        # SURVEY §4): dual side converged + primal infeasibility stuck +
        # diverging multipliers => primal infeasible; the mirrored
        # conditions with a diverging primal iterate => dual infeasible
        # (unbounded).
        tol = self.opts.tol
        stuck = 1e3 * tol
        dual_mag = jnp.maximum(
            K._inf_norm(y), jnp.maximum(K._inf_norm(zl), K._inf_norm(zu))
        )
        primal_infeas = (
            (inf_du <= tol) & (inf_compl <= tol) & (inf_pr > stuck)
            & (dual_mag > self.opts.diverge_tol)
        )
        dual_infeas = (
            (inf_pr <= tol) & (inf_compl <= tol) & (inf_du > stuck)
            & (K._inf_norm(x) > self.opts.diverge_tol)
        )
        diverged = primal_infeas | dual_infeas
        new_status = jnp.where(
            worst <= self.opts.tol,
            SUCCESS,
            jnp.where(
                diverged,
                DIVERGED,
                jnp.where(state.k >= self.opts.max_iter, MAX_ITER, RUNNING),
            ),
        ).astype(jnp.int32)
        # Before the starting point is computed the residuals above are
        # measured at the raw pushed x0 — never a termination verdict.
        new_status = jnp.where(initialized, new_status,
                               jnp.int32(RUNNING))

        # Stall detection (opts.stall_exit > 0, static): an f32 phase that
        # has hit its precision floor burns iterations without progress and
        # degrades the iterate it will hand to the f64 endgame — exit after
        # stall_exit consecutive iterations without a 10% improvement of the
        # best max-infeasibility seen.
        if self.opts.stall_exit > 0:
            improved = worst < 0.9 * state.best_worst
            stall_k = jnp.where(
                improved | ~initialized, jnp.int32(0), state.stall_k + 1
            )
            stalled = stall_k >= self.opts.stall_exit
            new_status = jnp.where(
                (new_status == RUNNING) & stalled, STALLED, new_status
            ).astype(jnp.int32)
            state = state._replace(
                best_worst=jnp.where(
                    initialized,
                    jnp.minimum(worst, state.best_worst),
                    state.best_worst,
                ),
                stall_k=stall_k,
            )

        def finish(s: IPMState) -> IPMState:
            # Preserve an already-terminal status: when the pipelined
            # stepped loop re-dispatches on a frozen state, new_status can
            # read RUNNING (recomputed from unchanged residuals) and must
            # not resurrect the state.
            return s._replace(status=jnp.where(
                s.status == RUNNING, new_status, s.status))

        def work(state: IPMState) -> IPMState:
            del_w, del_c, reg_p, reg_d = self._update_regularization(state)
            # First call (starting point): keep the init-regularization
            # seeds the cheap init_state stored (reference src/solver.jl:16-18
            # factorizes the del_w-seeded system; policies only start
            # evolving from iteration 0).
            del_w = jnp.where(initialized, del_w, state.del_w)
            del_c = jnp.where(initialized, del_c, state.del_c)
            reg_p = jnp.where(initialized, reg_p, state.reg_p)
            reg_d = jnp.where(initialized, reg_d, state.reg_d)
            with jax.named_scope("kkt_factorize"):
                factors, del_w, del_c, fact_ok = self.factorize_with_retry(
                    p, x, lb, ub, zl, zu, del_w, del_c
                )

            # Barrier-gate count.  The sigma-vs-1 gate is the traced count
            # of bounded entries (see state.count_onesided rationale); with
            # barrier_gate="one-sided" it reproduces the reference's gate
            # (src/kernels.jl:227-233: adaptive sigma only when one-sided
            # bounds exist) — see benchmarks/exp_barrier_gate.py.
            mu_curr = K.complementarity_measure(x, lb, ub, *masks, zl, zu)
            if self.opts.barrier_gate == "one-sided":
                n_bounded = (jnp.sum(p.has_lb & ~p.has_ub)
                             + jnp.sum(~p.has_lb & p.has_ub))
            else:
                n_bounded = jnp.sum(p.has_lb) + jnp.sum(p.has_ub)

            # Predictor + Mehrotra corrector + Gondzio corrections (or, on
            # the first call, the starting-point least-squares solves),
            # fused into one scanned backsolve (see _direction_scan).
            with jax.named_scope("direction"):
                d, mu_new, dir_failed = self._direction_scan(
                    p, factors, g, jacl, c_res, mu_curr, n_bounded,
                    x, lb, ub, zl, zu, del_w, del_c, initialized,
                )
            failed = (~fact_ok) | dir_failed

            # Step computation + iterate update.
            alpha_p, alpha_d = self._step_rule(p, d, x, lb, ub, zl, zu, mu_new)
            x_new = x + alpha_p * d.x
            y_new = y + alpha_d * d.y
            zl_new = jnp.where(p.has_lb, zl + alpha_d * d.zl, 0.0)
            zu_new = jnp.where(p.has_ub, zu + alpha_d * d.zu, 0.0)
            lb_new, ub_new = K.adjust_boundary(
                x_new, lb, ub, *masks, mu_new, self.eps
            )

            new_state = state._replace(
                x=x_new, y=y_new, zl=zl_new, zu=zu_new,
                lb=lb_new, ub=ub_new,
                d=d, mu=mu_new,
                del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
                alpha_p=alpha_p, alpha_d=alpha_d,
                d_norm=K._inf_norm(d.x),
                k=state.k + 1,
                n_fact=state.n_fact + 1,
                n_solve=state.n_solve + 2 + self.opts.max_ncorr,
            )
            new_state = _tree_select(
                failed, state._replace(status=jnp.int32(STEP_ERROR)), new_state
            )

            # First call: finish the Mehrotra starting point instead
            # (reference src/solver.jl:37-123 — bound-dual init from the
            # dual residual, positivity + second-order shifts, Ipopt
            # projection).  Solve failures are not fatal here, matching
            # the original init path (NaNs would surface at iteration 0).
            xi = x + d.x
            yi = d.y
            r = g + self.jtprod(p, yi)
            ones_n = jnp.ones(p.n, self.dtype)
            zli, zui = K.init_bound_duals(r, *masks, ones_n, ones_n)
            xi, zli, zui = K.mehrotra_positivity_shift(
                xi, lb, ub, *masks, zli, zui
            )
            xi = K.project_bound_fac(xi, lb, ub, *masks, self.opts.bound_fac)
            init_state = state._replace(
                x=xi, y=yi, zl=zli, zu=zui,
                mu=jnp.asarray(self.opts.mu_init, self.dtype),
                del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
                obj_val=self.objective(p, xi),
                n_fact=state.n_fact + 1,
                n_solve=state.n_solve + 2,
                initialized=jnp.asarray(True),
            )
            return _tree_select(initialized, new_state, init_state)

        # Also require state.status == RUNNING: a terminal state must stay
        # frozen when `iteration` is dispatched again (the pipelined
        # stepped loop reads status back only every few steps, and e.g. a
        # STEP_ERROR state would otherwise recompute status=RUNNING from
        # its unchanged residuals and silently retry).  The while_loop
        # path never dispatches on a terminal state, so this is a no-op
        # there.
        return lax.cond((new_status == RUNNING) & (state.status == RUNNING),
                        work, finish, state)

    # -- starting point (src/solver.jl:6-182) --------------------------------

    @_full_precision
    def init_state_warm(self, p, x0, y0, zl0, zu0, lb0, ub0) -> IPMState:
        """Warm start (beyond the reference): push the supplied primal-dual
        point strictly inside bounds/positivity and start iterating, skipping
        the three least-squares starting solves."""
        masks = (p.has_lb, p.has_ub)
        dt = self.dtype
        opt = self.opts

        lb, ub = K.relax_bounds(lb0, ub0, *masks, opt.bound_relax_factor)
        x = K.push_inside_bounds(
            x0, lb, ub, *masks, opt.bound_push, opt.bound_fac
        )
        floor = jnp.asarray(1e-8, dt)
        zl = jnp.where(p.has_lb, jnp.maximum(zl0, floor), 0.0)
        zu = jnp.where(p.has_ub, jnp.maximum(zu0, floor), 0.0)

        g = self.gradient(p, x)
        zero = jnp.asarray(0.0, dt)
        zero_n = jnp.zeros(p.n, dt)
        del_w, del_c, reg_p, reg_d = self._init_regularization()
        # Barrier consistent with the supplied point.
        mu0 = K.complementarity_measure(x, lb, ub, *masks, zl, zu)
        mu0 = jnp.clip(mu0, opt.mu_min, opt.mu_init)
        return IPMState(
            x=x, y=y0, zl=zl, zu=zu, lb=lb, ub=ub,
            d=K.KKTVec(x=zero_n, y=jnp.zeros(p.m, dt), zl=zero_n, zu=zero_n),
            mu=mu0,
            del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
            alpha_p=jnp.asarray(1.0, dt), alpha_d=jnp.asarray(1.0, dt),
            obj_val=self.objective(p, x),
            inf_pr=zero, inf_du=zero, inf_compl=zero,
            d_norm=zero,
            norm_b=K._inf_norm(p.b), norm_c=K._inf_norm(g),
            k=jnp.int32(0), n_fact=jnp.int32(0), n_solve=jnp.int32(0),
            status=jnp.int32(RUNNING),
            best_worst=jnp.asarray(jnp.inf, dt), stall_k=jnp.int32(0),
            initialized=jnp.asarray(True),
        )

    @_full_precision
    def init_state(self, p: ProblemArrays, x0, y0, lb0, ub0) -> IPMState:
        """Cheap pre-loop state: bound relaxation + interior push only.

        The Mehrotra starting point itself (del_w-seeded factorization, two
        least-squares KKT solves, bound-dual init, shifts, projection —
        reference src/solver.jl:6-123) runs inside the FIRST `iteration`
        call, gated on `initialized`, so a full solve traces exactly one
        factorize walk and one backsolve walk (the traced-walk count sets
        the cold-compile bill on the sparse paths).  With zl = zu = 0 the
        in-loop sigma diagonal is exactly del_w, so the first call's
        factorization IS the reference's starting-point system."""
        masks = (p.has_lb, p.has_ub)
        dt = self.dtype
        opt = self.opts

        lb, ub = K.relax_bounds(lb0, ub0, *masks, opt.bound_relax_factor)
        x = K.push_inside_bounds(
            x0, lb, ub, *masks, opt.bound_push, opt.bound_fac
        )
        zero_n = jnp.zeros(p.n, dt)

        del_w, del_c, reg_p, reg_d = self._init_regularization()

        g = self.gradient(p, x)
        norm_b = K._inf_norm(p.b)
        norm_c = K._inf_norm(g)

        zero = jnp.asarray(0.0, dt)
        return IPMState(
            x=x, y=y0, zl=zero_n, zu=zero_n, lb=lb, ub=ub,
            d=K.KKTVec(x=zero_n, y=jnp.zeros(p.m, dt), zl=zero_n, zu=zero_n),
            mu=jnp.asarray(opt.mu_init, dt),
            del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
            alpha_p=jnp.asarray(1.0, dt), alpha_d=jnp.asarray(1.0, dt),
            obj_val=self.objective(p, x),
            inf_pr=zero, inf_du=zero, inf_compl=zero,
            d_norm=zero, norm_b=norm_b, norm_c=norm_c,
            k=jnp.int32(0), n_fact=jnp.int32(0), n_solve=jnp.int32(0),
            status=jnp.int32(RUNNING),
            best_worst=jnp.asarray(jnp.inf, dt), stall_k=jnp.int32(0),
            initialized=jnp.asarray(False),
        )

    # -- drivers -------------------------------------------------------------

    @_full_precision
    def run(self, p: ProblemArrays, state: IPMState) -> IPMState:
        """Full solve under lax.while_loop (jit this)."""
        return lax.while_loop(
            lambda s: s.status == RUNNING,
            lambda s: self.iteration(p, s),
            state,
        )

    @_full_precision
    def run_k(self, p: ProblemArrays, state: IPMState, k) -> IPMState:
        """At most k iterations (host-chunked loops): exits early on any
        terminal status, so one dispatch's wall is bounded by k iteration
        times — the middle ground between per-iteration stepping (a host
        round trip per iteration) and the unbounded while_loop.  k is
        traced — one compile serves every chunk length."""

        def cond(c):
            s, i = c
            return jnp.logical_and(s.status == RUNNING, i < k)

        def body(c):
            s, i = c
            return self.iteration(p, s), i + 1

        out, _ = lax.while_loop(cond, body, (state, jnp.int32(0)))
        return out

    @_full_precision
    def solve_from(self, p: ProblemArrays, x0, y0, lb0, ub0) -> IPMState:
        """init + run as a single traced computation."""
        return self.run(p, self.init_state(p, x0, y0, lb0, ub0))

    @_full_precision
    def solve_from_warm(self, p, x0, y0, zl0, zu0, lb0, ub0) -> IPMState:
        """Warm-started solve as a single traced computation."""
        return self.run(p, self.init_state_warm(p, x0, y0, zl0, zu0, lb0, ub0))
