"""madqp_tpu — an LP/QP interior-point framework in JAX.

Brand-new implementation of the Mehrotra predictor-corrector interior-point
method with the capabilities of MadIPM.jl (the MadNLP/MadQP reference):
masked dense state pytrees, jitted lax.while_loop MPC iterations, dense and
supernodal-sparse KKT factorizations, and vmap/shard_map scale-out.

Double precision is required for the 1e-8 tolerances of the reference
protocol, so x64 is enabled at import; the mixed-precision paths trade an
f32 factorization plus f64 refinement for speed.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache lives at a fixed path in the checkout, so that every
# process of a deployment (and every run of it) finds the same entries.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"),
    )

from .utils import (  # noqa: E402
    Status,
    ExecutionStats,
    Counters,
    IPMOptions,
    Mehrotra,
    ConservativeStep,
    AdaptiveStep,
    MehrotraAdaptiveStep,
    NoRegularization,
    FixedRegularization,
    AdaptiveRegularization,
    KKTSystem,
    LinearSolverBackend,
    MadLogger,
)
from .models import (  # noqa: E402
    QuadraticProblem,
    StandardQP,
    build_standard_form,
    from_coo,
    dense_dummy_qp,
    simple_lp,
    random_lp,
    random_qp,
    banded_sparse_lp,
    separable_qp,
    ineq_qp,
    grid_lp,
    grid3d_lp,
    netflow_grid_lp,
    scale_qp,
    unscale_stats,
    presolve_qp,
)
from .io import read_mps, write_mps  # noqa: E402
from .diff import qp_layer, qp_layer_general, QPLayerSolution  # noqa: E402
from .solver import (  # noqa: E402
    MPCSolver,
    solve,
    autosolve,
    HostMPCSolver,
    solve_host,
    solve_sparse_lp,
    solve_sparse_qp,
    solve_sparse_condensed,
)

__version__ = "0.1.0"

__all__ = [
    "Status",
    "ExecutionStats",
    "Counters",
    "IPMOptions",
    "Mehrotra",
    "ConservativeStep",
    "AdaptiveStep",
    "MehrotraAdaptiveStep",
    "NoRegularization",
    "FixedRegularization",
    "AdaptiveRegularization",
    "KKTSystem",
    "LinearSolverBackend",
    "MadLogger",
    "QuadraticProblem",
    "StandardQP",
    "build_standard_form",
    "from_coo",
    "dense_dummy_qp",
    "simple_lp",
    "random_lp",
    "random_qp",
    "scale_qp",
    "unscale_stats",
    "presolve_qp",
    "read_mps",
    "write_mps",
    "qp_layer",
    "qp_layer_general",
    "QPLayerSolution",
    "MPCSolver",
    "solve",
    "autosolve",
    "HostMPCSolver",
    "solve_host",
    "solve_sparse_lp",
    "solve_sparse_qp",
    "solve_sparse_condensed",
    "banded_sparse_lp",
    "separable_qp",
    "ineq_qp",
    "grid_lp",
    "grid3d_lp",
    "netflow_grid_lp",
]
