"""Batched sparse solving: vmap the supernodal sparse path over instances
sharing one sparsity pattern.

Accelerator scale-out with no reference analog (SURVEY §2.5: the
reference is one-process/one-GPU; cuDSS offers no cross-instance batching
of a shared symbolic).  The symbolic analysis (ordering, supernodes,
level buckets — the expensive host phase) is computed ONCE from the
shared pattern; the numeric phase vmaps over the instance axis, so every
bucketed dense-front factorization becomes one bigger batched matmul.  Lanes
that converge freeze via the vmapped `lax.while_loop` convergence
masking, exactly like the dense batched path (parallel/batched.py).

Use cases: scenario sweeps of one model (same network, different data),
receding-horizon re-solves, Monte-Carlo LP/QP studies.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..solver.mpc import MPCKernel
from ..solver.sparse_common import (canonical_coo_vals, canonical_csc,
                                    pattern_fingerprint, two_phase_opts)
from ..solver.sparse_lp import DeviceSparseNormalKKT
from ..solver.sparse_qp import DeviceSparseAugmentedKKT, SparseQPProblem
from ..solver.driver import _STATUS_MAP
from ..utils import Counters, ExecutionStats, Status, load_options


def _diag_hessian(H) -> bool:
    import scipy.sparse as sp

    if H is None or H.nnz == 0:
        return True
    Hcoo = sp.coo_matrix(H)
    return bool((Hcoo.row == Hcoo.col).all())


def _mesh_key(mesh: Optional[Mesh]):
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), mesh.devices.shape,
            tuple(d.id for d in mesh.devices.flat))


# Pattern-keyed cache of (kkt, kernel, wrapped-jit) per phase, mirroring
# sparse_common.get_sparse_kernel: the vmapped supernodal trace is the
# dominant fixed cost of a batched solve (retrace >> device time), and the
# KKT objects bake only the PATTERN (values arrive via SparseQPProblem),
# so reuse across same-pattern batches is safe.
_BATCHED_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_BATCHED_CACHE_SIZE = 8


def solve_sparse_batched(
    qps: Sequence[QuadraticProblem],
    order: str = "auto",
    kkt_system: str = "auto",
    mesh: Optional[Mesh] = None,
    batch_axis: str = "batch",
    **options,
) -> List[ExecutionStats]:
    """Solve a batch of same-pattern sparse LPs/QPs in lockstep.

    All instances must share the sparsity patterns of A (and H); values,
    rhs, costs, and bounds may differ.  kkt_system as in solve_sparse_qp:
    'auto' picks normal equations when the Hessian is absent/diagonal.
    """
    if not qps:
        return []
    opts, _ = load_options(**options)
    built = [
        build_standard_form_sparse(qp, scaling=opts.scaling,
                                   max_gradient=opts.max_gradient)
        for qp in qps
    ]
    stds = [b[0] for b in built]
    infos = [b[1] for b in built]
    fps = {pattern_fingerprint(s.A, s.H) for s in stds}
    if len(fps) != 1:
        raise ValueError(
            "solve_sparse_batched requires all instances to share the "
            f"A/H sparsity pattern (got {len(fps)} distinct patterns); "
            "use parallel.solve_batched (dense, padded) for ragged batches."
        )
    std0 = stds[0]
    use_normal = kkt_system != "augmented" and _diag_hessian(std0.H)
    if kkt_system == "normal" and not _diag_hessian(std0.H):
        raise ValueError("kkt_system='normal' needs an LP or diagonal Hessian.")

    two_phase = (opts.factorization_dtype == "float32"
                 and opts.precision_scheme == "two-phase"
                 and opts.tol < opts.phase1_tol)
    opts1, opts2 = two_phase_opts(opts) if two_phase else (opts, None)

    def make_kkt(o):
        fd = o.factorization_dtype or None
        inv = o.solve_mode == "inverse"
        if use_normal:
            return DeviceSparseNormalKKT(std0.A, order=order,
                                         fact_dtype=fd, inverse=inv)
        return DeviceSparseAugmentedKKT(std0.H, std0.A, order=order,
                                        fact_dtype=fd, inverse=inv)

    fp = fps.pop()
    mkey = _mesh_key(mesh)

    def cached(o, entry, build):
        key = (fp, o, use_normal, order, mkey, batch_axis, entry)
        hit = _BATCHED_CACHE.get(key)
        if hit is not None:
            _BATCHED_CACHE.move_to_end(key)
            return hit
        val = build()
        _BATCHED_CACHE[key] = val
        while len(_BATCHED_CACHE) > _BATCHED_CACHE_SIZE:
            _BATCHED_CACHE.popitem(last=False)
        return val

    kkt1 = cached(opts1, "kkt", lambda: make_kkt(opts1))

    # --- stacked problem arrays (canonical CSC value order per instance) --
    dtype = jnp.dtype(opts.dtype)
    n_real = len(qps)
    n_dev = mesh.devices.size if mesh is not None else 1
    idx = list(range(n_real))
    while len(idx) % n_dev != 0:
        idx.append(idx[-1])     # replicate the last instance to fill shards

    stack = lambda f: jnp.asarray(np.stack([f(stds[i]) for i in idx]), dtype)
    if std0.H is not None and std0.H.nnz:
        Hcoo = canonical_csc(std0.H).tocoo()
        h_rows = jnp.asarray(Hcoo.row.astype(np.int32))
        h_cols = jnp.asarray(Hcoo.col.astype(np.int32))
        h_vals = stack(lambda s: canonical_coo_vals(s.H))
        h_ax = 0
    else:
        h_rows = jnp.zeros((0,), jnp.int32)
        h_cols = jnp.zeros((0,), jnp.int32)
        h_vals = jnp.zeros((0,), dtype)
        h_ax = None
    prob = SparseQPProblem(
        c0=stack(lambda s: s.c0),
        c=stack(lambda s: s.c),
        b=stack(lambda s: s.b),
        has_lb=jnp.asarray(np.stack([stds[i].has_lb for i in idx])),
        has_ub=jnp.asarray(np.stack([stds[i].has_ub for i in idx])),
        a_rows=jnp.asarray(kkt1.coo_rows),
        a_cols=jnp.asarray(kkt1.coo_cols),
        a_vals=stack(lambda s: canonical_coo_vals(s.A)),
        h_rows=h_rows, h_cols=h_cols, h_vals=h_vals,
    )
    in_axes_prob = SparseQPProblem(
        c0=0, c=0, b=0, has_lb=0, has_ub=0,
        a_rows=None, a_cols=None, a_vals=0,
        h_rows=None, h_cols=None, h_vals=h_ax,
    )
    x0 = jnp.asarray(np.stack([built[i][2] for i in idx]), dtype)
    y0 = jnp.asarray(np.stack([built[i][3] for i in idx]), dtype)
    lb = jnp.asarray(np.stack([stds[i].lb for i in idx]), dtype)
    ub = jnp.asarray(np.stack([stds[i].ub for i in idx]), dtype)

    def wrap(fn, n_state_args):
        batched = jax.vmap(fn, in_axes=(in_axes_prob,) + (0,) * n_state_args)
        if mesh is None:
            return jax.jit(batched)
        bspec = P(batch_axis)
        spec_p = SparseQPProblem(
            c0=bspec, c=bspec, b=bspec, has_lb=bspec, has_ub=bspec,
            a_rows=P(), a_cols=P(), a_vals=bspec,
            h_rows=P(), h_cols=P(),
            h_vals=bspec if h_ax == 0 else P(),
        )
        specs = (spec_p,) + (bspec,) * n_state_args
        return jax.jit(jax.shard_map(
            batched, mesh=mesh, in_specs=specs, out_specs=bspec,
            check_vma=False,
        ))

    solve1 = cached(opts1, "solve",
                    lambda: wrap(MPCKernel(opts1, kkt=kkt1).solve_from, 4))

    t0 = time.time()
    with jax.default_matmul_precision("highest"):
        final = jax.block_until_ready(solve1(prob, x0, y0, lb, ub))
        extra = None
        if two_phase:
            extra = np.asarray(final.k, np.int64)
            solve2 = cached(opts2, "warm_solve", lambda: wrap(
                MPCKernel(opts2, kkt=cached(opts2, "kkt",
                                            lambda: make_kkt(opts2)))
                .solve_from_warm, 6))
            final = jax.block_until_ready(
                solve2(prob, final.x, final.y, final.zl, final.zu, lb, ub)
            )
    wall = time.time() - t0

    final = jax.device_get(final)
    out = []
    for lane, i in enumerate(idx[:n_real]):
        info = infos[i]
        qp = qps[i]
        x_user = info.recover_x(np.asarray(final.x[lane], np.float64)[: info.n])
        y_user = info.recover_y(np.asarray(final.y[lane], np.float64)[: info.m])
        g_user = qp.grad(x_user)
        r_fix = g_user + qp.jtprod(y_user)
        zl_user = info.recover_z(
            np.asarray(final.zl[lane], np.float64)[: info.n],
            np.maximum(r_fix, 0.0))
        zu_user = info.recover_z(
            np.asarray(final.zu[lane], np.float64)[: info.n],
            np.maximum(-r_fix, 0.0))
        k = int(final.k[lane]) + (int(extra[lane]) if extra is not None else 0)
        out.append(ExecutionStats(
            status=_STATUS_MAP.get(int(final.status[lane]),
                                   Status.INTERNAL_ERROR),
            objective=float(qp.obj(x_user)),
            solution=x_user,
            constraints=qp.cons(x_user),
            multipliers=y_user,
            multipliers_L=zl_user,
            multipliers_U=zu_user,
            iter=k,
            counters=Counters(total_time=wall, k=k),
            primal_feas=float(final.inf_pr[lane]),
            dual_feas=float(final.inf_du[lane]),
            complementarity=float(final.inf_compl[lane]),
            options=opts,
        ))
    return out
