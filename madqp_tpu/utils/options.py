"""Typed option system and policy objects.

Equivalent of the reference option cascade
(/root/reference/src/utils.jl:69-146): a frozen dataclass of solver options
with policy objects (step rule, regularization, barrier update) passed as
*values*.  Frozen/hashable so the whole options object can be a static
argument to `jax.jit` — the policy dispatch happens at trace time, exactly
like Julia's dispatch-on-type happens at compile time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Problem classes (reference: src/utils.jl:1-4)
# ---------------------------------------------------------------------------


class ProblemClass:
    LINEAR = "lp"
    QUADRATIC = "qp"


# ---------------------------------------------------------------------------
# Barrier update policies (reference: src/utils.jl:10-11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mehrotra:
    """Mehrotra adaptive centering: sigma = clamp((mu_aff/mu)^3, 1e-6, 10).

    For pure LPs without inequalities the reference forces sigma = 1
    (src/kernels.jl:226-236).
    """

    sigma_min: float = 1e-6
    sigma_max: float = 10.0


# ---------------------------------------------------------------------------
# Step rules (reference: src/utils.jl:17-29, impls src/kernels.jl:307-374)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConservativeStep:
    """Fixed fraction-to-boundary factor tau."""

    tau: float = 0.995


@dataclasses.dataclass(frozen=True)
class AdaptiveStep:
    """tau = max(1 - mu, tau_min)."""

    tau_min: float = 0.99


@dataclasses.dataclass(frozen=True)
class MehrotraAdaptiveStep:
    """Mehrotra's GTSF procedure (per-blocking-index rescue of alpha)."""

    gamma_f: float = 0.99


StepRule = ConservativeStep | AdaptiveStep | MehrotraAdaptiveStep


# ---------------------------------------------------------------------------
# Regularization policies (reference: src/utils.jl:35-48, src/kernels.jl:380-417)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NoRegularization:
    """del_w = 1 at init (for the starting-point KKT), 0 in the loop."""


@dataclasses.dataclass(frozen=True)
class FixedRegularization:
    """Constant primal delta_p >= 0 and dual delta_d <= 0 regularization."""

    delta_p: float = 1e-8
    delta_d: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdaptiveRegularization:
    """Divide both deltas by 10 each iteration, floored at delta_min."""

    delta_p: float = 1e-8
    delta_d: float = -1e-9
    delta_min: float = 1e-9


Regularization = NoRegularization | FixedRegularization | AdaptiveRegularization


# ---------------------------------------------------------------------------
# KKT formulation / linear solver selection
# ---------------------------------------------------------------------------


class KKTSystem:
    """Names of the KKT formulations (reference SURVEY §2.3)."""

    K2 = "k2"                  # augmented symmetric-indefinite system
    K2_5 = "k2.5"              # diagonally scaled augmented system
    CONDENSED = "condensed"    # eliminate bound duals + primal block (SPD Schur)
    NORMAL = "normal"          # normal equations A Sigma^-1 A^T (LP only)


class LinearSolverBackend:
    DENSE = "dense"            # padded dense factorization (lax.linalg)
    BLOCKED = "blocked"        # GEMM-rich blocked LDL + explicit triangular
                               # inverse (ops/blocked_dense): backsolves are
                               # matvecs; avoids XLA's sequential sweeps
    SPARSE = "sparse"          # host symbolic + on-device numeric (block sparse)


# ---------------------------------------------------------------------------
# Main options (reference: IPMOptions, src/utils.jl:69-117)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    # Convergence
    tol: float = 1e-8
    max_iter: int = 3000
    max_wall_time: float = 1e6   # seconds; enforced host-side between runs
    measure_linear_solver: bool = False  # post-solve factorize/backsolve timing
    kappa_d: float = 1e-5
    # KKT / linear solver
    kkt_system: str = KKTSystem.CONDENSED
    linear_solver: str = LinearSolverBackend.DENSE
    tol_linear_solve: float = 1e-8
    check_residual: bool = False
    max_refine_steps: int = 0   # iterative-refinement rounds per backsolve
    # 'chol' = triangular backsolves (default); 'inverse' = explicit
    # inverses of the scaled SPD blocks so every backsolve is one matvec —
    # only pays off when many backsolves share one factorization (large
    # max_ncorr / many refinement steps).  Combine 'inverse' with
    # max_refine_steps >= 1.
    solve_mode: str = "chol"
    # Sparse mixed precision (factorization_dtype='float32' on the sparse
    # device paths): 'two-phase' runs the f32 kernel to phase1_tol then a
    # warm-started f64 endgame to tol — f32 factors of a cond>1e7 KKT stall
    # short of 1e-8 no matter how much refinement is applied, so the last
    # few iterations must pay f64.  'simple' = single-phase f32+IR.
    precision_scheme: str = "two-phase"
    phase1_tol: float = 1e-3
    # Endgame of the two-phase scheme: "f64" refactorizes in f64 on the
    # device (the f64 supernodal program is a second large XLA compile);
    # "krylov" keeps the f32 pivot-floored factorization as a
    # PRECONDITIONER for f64 conjugate gradients on the SPD reduced system
    # (normal equations / condensed), so only matvecs run in f64;
    # "host" hands the f32 phase's terminal iterate to the host C++ LDL
    # solver (warm start) so the f64 XLA program never compiles at all —
    # the cheapest cold-start option on new sparse patterns.
    # "auto" (default) resolves to "host" when the native library is
    # available, else "f64", so a pattern seen once pays no f64 compile.
    # Hot same-pattern re-solve loops should pin endgame="f64" to
    # amortize the compile instead.
    endgame: str = "auto"
    krylov_tol: float = 1e-12   # PCG relative-residual target
    krylov_maxit: int = 64
    # Supernodal schedule for the sparse device paths (ops/sparse_chol):
    # "greedy" (default) = coarse shape classes + availability rounds +
    # scan-grouped same-shape runs — several times smaller XLA programs
    # at the price of more padded front flops.  "level" = tight pow2
    # pads, per-level buckets, chains — fewer padded flops for hot
    # re-solve loops pinned to endgame="f64", where the compile
    # amortizes.
    sparse_schedule: str = "greedy"
    # Internal: phase-2 marker set by two_phase_opts for endgame="krylov"
    # (selects the PCG solve path in the sparse KKT construction).
    krylov_solve: bool = False
    # Exit the loop with Status.SOLVED_TO_ACCEPTABLE_LEVEL after this many
    # consecutive iterations without a 10% improvement of the best
    # max-infeasibility (0 = disabled).  The two-phase drivers enable it for
    # the f32 phase: an f32 kernel at its precision floor burns iterations
    # and degrades the warm start it hands to the f64 endgame.
    stall_exit: int = 0
    # Iteration cap for the f32 phase whenever a full-precision rescue /
    # endgame phase exists (two-phase sparse drivers, dense + batched
    # mixed-precision rescue).  Stall detection catches monotone
    # stagnation but not oscillation: a degenerate lane that cycles at
    # its f32 precision floor otherwise burns the full max_iter (default
    # 3000 — the reference benchmark configs use 300) in lockstep before
    # the rescue is allowed to run.  Healthy f32 phases
    # finish in 10-40 iterations, so 80 is ~2x headroom.  Capped lanes
    # exit with MAX_ITER; the sparse/dense phase-2 endgames warm-start
    # from the phase-1 iterate, but the batched host rescue
    # (parallel/batched.py::_host_rescue) is a cold re-solve — raising
    # this cap trades f32 lockstep time against cold host re-solves for
    # genuinely hard lanes.  Must be >= 1 (validated in load_options);
    # only applied where a phase 2 exists — single-phase solves keep
    # max_iter untouched.  Raise it for very hard instances that
    # legitimately need >80 f32 iterations before the endgame.
    phase1_max_iter: int = 80
    # Output — Python-logging-style thresholds (HIGHER = quieter):
    # 5=TRACE 10=DEBUG 20=INFO 25=NOTICE 30=WARN 40=ERROR.  0 is NOTSET and
    # means "logging disabled" (silent), matching both Python logging's
    # convention and the intuitive reading of print_level=0; it is
    # normalized to 100 in load_options.  print_level <= 20 also switches
    # the driver to the host-stepped per-iteration loop so the iteration
    # table can print live.
    print_level: int = 20       # logging.INFO
    file_print_level: int = 20
    output_file: str = ""
    rethrow_error: bool = False
    # Initialization
    scaling: bool = True
    max_gradient: float = 100.0
    bound_push: float = 1e-2
    bound_fac: float = 1e-2
    bound_relax_factor: float = 1e-8
    # Fixed-variable treatment (reference src/utils.jl:81-82):
    # "make_parameter" eliminates lvar==uvar columns by substitution;
    # "relax_bound" keeps them, widening the bound pair by
    # bound_relax_factor * max(1, |value|) on each side (the reference's
    # default for the condensed KKT system).
    fixed_variable_treatment: str = "make_parameter"
    # Policies
    regularization: Regularization = FixedRegularization(1e-8, 0.0)
    step_rule: StepRule = AdaptiveStep(0.99)
    barrier_update: Mehrotra = Mehrotra()
    # Gate for the Mehrotra sigma-vs-1 branch.  The reference applies the
    # adaptive cube rule only when ONE-SIDED bounds exist
    # (src/kernels.jl:227-233: ind_llb/ind_uub nonempty), forcing sigma=1
    # otherwise.  "any-bound" (default) applies it whenever any finite
    # bound exists: sigma=1 stalls on bounds-only (two-sided) problems —
    # see benchmarks/exp_barrier_gate.py for the A/B trajectories.
    barrier_gate: str = "any-bound"  # or "one-sided" (reference behavior)
    max_ncorr: int = 0          # Gondzio multi-corrections
    s_max: float = 100.0
    mu_init: float = 1e-1
    mu_min: float = 1e-11
    mu_superlinear_decrease_power: float = 1.5
    tau_min: float = 0.99
    # Infeasibility detection (beyond the reference, which only stops on
    # tol/max_iter — SURVEY §4 gap): declare infeasibility when one side of
    # the KKT conditions has converged, the other is stuck above
    # sqrt-ish tolerance, and the corresponding iterates have diverged past
    # this magnitude.
    diverge_tol: float = 1e8
    # Sparse-device normal equations: route m <= this to ONE dense
    # factorization of the assembled S = A D A' (sparse assembly stays
    # segment-sum) instead of the supernodal scan, whose many small
    # bucket ops are latency-bound at small m.  The crossover is the
    # explicit triangular inverse's ~2.4x-of-cholesky flop bill against
    # the supernodal scan's per-iteration wall.  The value was tuned on
    # earlier hardware and awaits a sweep on the current one.
    dense_normal_limit: int = 12288
    # Numerics: dtype of the on-device solver state, and an optionally
    # lower dtype for the KKT factorization.  float32 factorization + f64
    # iterative refinement (set max_refine_steps >= 1) is the
    # mixed-precision configuration.
    dtype: str = "float64"
    factorization_dtype: str = ""  # "" = same as dtype
    # Dtype of the WHOLE phase-1 state on the two-phase sparse drivers
    # ("" = same as dtype).  phase1_dtype='float32' runs phase 1 entirely
    # in f32 (vectors, matvecs, reductions); the f64 endgame re-measures
    # everything at full precision from the cast-up warm start, so the
    # final tolerance is unaffected.  Phase 1 only needs phase1_tol
    # (1e-3) — far above the f32 precision floor.
    phase1_dtype: str = "float32"
    # Execution mode: "jit" runs the whole solve in one lax.while_loop;
    # "python" steps the jitted iteration from the host (debuggable, prints
    # eagerly); "auto" = host-chunked on the pattern-specific sparse device
    # paths (the while-loop wrapper costs more XLA compile than the
    # iteration program it wraps), "jit" elsewhere.
    loop_mode: str = "auto"
    # Shape bucketing for suite runs (SURVEY §7.3: ragged suites force
    # recompilation): "bucket" pads the internal problem to power-of-two
    # shape buckets so instances share compiled executables.
    pad_mode: str = ""
    # Warm starting is driver-level state, not an option: use
    # MPCSolver.set_initial_point() / clear_initial_point().

    def replace(self, **kwargs) -> "IPMOptions":
        return dataclasses.replace(self, **kwargs)


def load_options(**kwargs) -> Tuple[IPMOptions, dict]:
    """Build IPMOptions from kwargs; return (options, ignored_kwargs).

    Mirrors the reference's cascade (src/utils.jl:119-146): recognized keys
    set IPMOptions fields, leftovers are returned for the caller to log as
    ignored.
    """
    fields = {f.name for f in dataclasses.fields(IPMOptions)}
    known = {k: v for k, v in kwargs.items() if k in fields}
    ignored = {k: v for k, v in kwargs.items() if k not in fields}
    # Accept the sparse-path spellings on the dense path too, so one
    # kkt_system vocabulary works everywhere ("augmented" == K2,
    # "scaled" == K2.5).
    aliases = {"augmented": KKTSystem.K2, "scaled": KKTSystem.K2_5}
    if known.get("kkt_system") in aliases:
        known["kkt_system"] = aliases[known["kkt_system"]]
    # print_level=0 is NOTSET = "logging disabled", not "print everything"
    # (thresholds are higher-is-quieter; see the field comment).
    for key in ("print_level", "file_print_level"):
        if known.get(key) == 0:
            known[key] = 100
    if known.get("sparse_schedule", "greedy") not in ("greedy", "level"):
        raise ValueError(
            f"sparse_schedule={known['sparse_schedule']!r} is not "
            "supported; choose one of 'greedy', 'level'."
        )
    if known.get("endgame", "auto") not in ("auto", "f64", "krylov",
                                            "host"):
        raise ValueError(
            f"endgame={known['endgame']!r} is not supported; "
            "valid values: 'f64', 'krylov', 'host'")
    backends = [v for k, v in vars(LinearSolverBackend).items()
                if k.isupper()]
    if known.get("linear_solver", "dense") not in backends:
        raise ValueError(
            f"linear_solver={known['linear_solver']!r} is not supported; "
            f"valid values: {backends}")
    if known.get("loop_mode", "auto") not in ("auto", "jit", "python"):
        raise ValueError(
            f"loop_mode={known['loop_mode']!r} is not supported; "
            "valid values: 'auto', 'jit', 'python'")
    if known.get("phase1_max_iter", 80) < 1:
        raise ValueError(
            f"phase1_max_iter={known['phase1_max_iter']} must be >= 1 "
            "(a zero-iteration f32 phase would still compile but push "
            "all work to the expensive full-precision rescue)")
    return IPMOptions(**known), ignored
