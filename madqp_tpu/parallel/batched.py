"""Batched QP solving: vmap over padded instances, sharded over a mesh.

This is the accelerator scale-out absent from the reference (SURVEY §2.5:
"batched-instance parallelism = vmap over padded QP batches + shard over
mesh", BASELINE config #4).  Instances are padded to a common internal shape:

  * padding variables get c = 0, unit Hessian diagonal (QP), box bounds
    [-1, 1] so their barrier terms keep the condensed diagonal positive;
  * padding constraint rows pin one padding variable each (x_pad = 0), so
    the Schur complement stays nonsingular;
  * convergence masking is inherited from the vmapped lax.while_loop: lanes
    whose status leaves RUNNING stop updating while the rest iterate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.qp import QuadraticProblem, StandardQP, TransformInfo, build_standard_form
from ..solver.mpc import MPCKernel
from ..solver.state import ProblemArrays
from ..solver import state as S
from ..utils import Counters, ExecutionStats, Status, load_options
from ..utils.options import IPMOptions

_STATUS_MAP = {
    S.SUCCESS: Status.SOLVE_SUCCEEDED,
    S.MAX_ITER: Status.MAXIMUM_ITERATIONS_EXCEEDED,
    S.STEP_ERROR: Status.ERROR_IN_STEP_COMPUTATION,
    S.DIVERGED: Status.DIVERGING_ITERATES,
    S.STALLED: Status.SOLVED_TO_ACCEPTABLE_LEVEL,
    S.RUNNING: Status.REGULAR,
}


def pad_standard(
    std: StandardQP, x0, y0, n_tot: int, m_tot: int, force_H: bool
) -> tuple[StandardQP, np.ndarray, np.ndarray]:
    """Pad one internal standard form to (n_tot, m_tot)."""
    n, m = std.n, std.m
    nd, md = n_tot - n, m_tot - m
    assert nd >= md, "need one padding variable per padding row"

    c = np.concatenate([std.c, np.zeros(nd)])
    b = np.concatenate([std.b, np.zeros(md)])
    A = np.zeros((m_tot, n_tot))
    A[:m, :n] = std.A
    # Pin the first md padding variables with the padding rows.
    for j in range(md):
        A[m + j, n + j] = 1.0

    H = None
    if force_H:
        H = np.zeros((n_tot, n_tot))
        if std.H is not None:
            H[:n, :n] = std.H
        # Unit curvature on padding variables keeps W well-conditioned.
        for j in range(nd):
            H[n + j, n + j] = 1.0

    lb = np.concatenate([std.lb, np.full(nd, -1.0)])
    ub = np.concatenate([std.ub, np.full(nd, 1.0)])
    has_lb = np.concatenate([std.has_lb, np.full(nd, True)])
    has_ub = np.concatenate([std.has_ub, np.full(nd, True)])

    padded = StandardQP(
        c0=std.c0, c=c, H=H, A=A, b=b,
        lb=lb, ub=ub, has_lb=has_lb, has_ub=has_ub,
    )
    x0p = np.concatenate([x0, np.zeros(nd)])
    y0p = np.concatenate([y0, np.zeros(md)])
    return padded, x0p, y0p


@dataclasses.dataclass
class BatchedMPCSolver:
    """Solve a batch of QPs in lockstep on one or many devices."""

    prob: ProblemArrays          # leading batch axis on every leaf
    x0: jax.Array
    y0: jax.Array
    lb: jax.Array
    ub: jax.Array
    infos: List[TransformInfo]
    qps: List[QuadraticProblem]
    opts: IPMOptions
    n_real: int                  # instances before batch padding
    mesh: Optional[Mesh] = None
    batch_axis: str = "batch"

    @classmethod
    def from_problems(
        cls,
        qps: Sequence[QuadraticProblem],
        mesh: Optional[Mesh] = None,
        batch_axis: str = "batch",
        **options,
    ) -> "BatchedMPCSolver":
        opts, _ = load_options(**options)
        built = [
            build_standard_form(qp, scaling=opts.scaling, max_gradient=opts.max_gradient)
            for qp in qps
        ]
        stds = [b[0] for b in built]
        infos = [b[1] for b in built]
        x0s = [b[2] for b in built]
        y0s = [b[3] for b in built]

        m_tot = max(s.m for s in stds)
        n_tot = max(s.n + (m_tot - s.m) for s in stds)
        force_H = any(s.H is not None for s in stds)

        padded = [
            pad_standard(s, x, y, n_tot, m_tot, force_H)
            for s, x, y in zip(stds, x0s, y0s)
        ]

        n_real = len(qps)
        n_dev = mesh.devices.size if mesh is not None else 1
        # Round the batch up to a multiple of the mesh size.
        while len(padded) % n_dev != 0:
            padded.append(padded[-1])

        dtype = jnp.dtype(opts.dtype)
        stack = lambda xs: jnp.asarray(np.stack(xs), dtype)
        prob = ProblemArrays(
            c0=stack([p.c0 for p, _, _ in padded]),
            c=stack([p.c for p, _, _ in padded]),
            H=stack([p.H for p, _, _ in padded]) if force_H else None,
            A=stack([p.A for p, _, _ in padded]),
            b=stack([p.b for p, _, _ in padded]),
            has_lb=jnp.asarray(np.stack([p.has_lb for p, _, _ in padded])),
            has_ub=jnp.asarray(np.stack([p.has_ub for p, _, _ in padded])),
        )
        x0 = stack([x for _, x, _ in padded])
        y0 = stack([y for _, _, y in padded])
        lb = stack([p.lb for p, _, _ in padded])
        ub = stack([p.ub for p, _, _ in padded])

        solver = cls(
            prob=prob, x0=x0, y0=y0, lb=lb, ub=ub,
            infos=infos, qps=list(qps), opts=opts, n_real=n_real,
            mesh=mesh, batch_axis=batch_axis,
        )
        solver._compile()
        return solver

    def _compile(self):
        def _wrap(fn):
            if self.mesh is not None:
                # shard_map over the batch axis: each device runs the
                # vmapped solver on its local sub-batch — embarrassingly
                # parallel, no collectives (SURVEY §7.2 M5).  check_vma
                # off: the computation is purely local per shard, but
                # lax.cond branches mix freshly-created (unvarying) and
                # input-derived (varying) leaves of the state.
                spec = P(self.batch_axis)
                fn = jax.shard_map(
                    fn, mesh=self.mesh, in_specs=spec, out_specs=spec,
                    check_vma=False,
                )
            return jax.jit(fn)

        if self.mesh is not None:
            shard = NamedSharding(self.mesh, P(self.batch_axis))
            shard_tree = lambda tree: jax.tree.map(
                lambda x: jax.device_put(x, shard), tree
            )
            self.prob = shard_tree(self.prob)
            self.x0, self.y0 = shard_tree((self.x0, self.y0))
            self.lb, self.ub = shard_tree((self.lb, self.ub))

        opts = self.opts
        # Chunked host-stepped loop for LARGE batches: a vmapped
        # lax.while_loop runs the whole lockstep solve (up to max_iter
        # iterations of every lane) in ONE device dispatch; loop_mode='auto'
        # bounds each dispatch's work instead, gating on an estimated work
        # bound — lanes x dim^3/3 x max_iter, scaled 10x for f64
        # factorizations — and on dim >= 512.  Small cheap batches keep the
        # single-program path, where stepping would add dispatch latency.
        # The bounds were set on earlier hardware; whether the GPU needs
        # chunking at all is an open measurement.
        dim = int(self.prob.c.shape[-1])
        lanes = int(self.prob.c.shape[0])

        def _eff_f64(o) -> bool:
            return (o.factorization_dtype or o.dtype) == "float64"

        def _flops(o) -> float:
            per_iter = lanes * dim ** 3 / 3.0
            return o.max_iter * per_iter * (10.0 if _eff_f64(o) else 1.0)

        stepped = opts.loop_mode == "python" or (
            opts.loop_mode == "auto"
            and (dim >= 512 or _flops(opts) > 5e11))

        def _chunk_iters(o, nlanes=None) -> int:
            # Cap the per-dispatch work (~5e10 flops in f32, 10x less in
            # f64), clamped to [1, 32] f32 / [1, 8] f64.  The cap bounds
            # the WORST case only: the chunk is a capped while_loop that
            # exits as soon as every lane is terminal, so a generous cap
            # costs nothing when lanes converge early.
            per_iter = max((nlanes or lanes) * dim ** 3 / 3.0, 1.0)
            hi, target = (8, 5e9) if _eff_f64(o) else (32, 5e10)
            return max(1, min(hi, int(target / per_iter)))

        def _stepped_run(kernel, warm: bool, chunk: int):
            def chunk_fn(prob, st):
                # Bounded-iteration while_loop: under vmap this lowers to
                # the same select-masked lockstep as the full solve (lanes
                # whose status leaves RUNNING freeze), but each dispatch
                # runs at most `chunk` iterations and exits EARLY once the
                # whole batch is terminal.
                k0 = st.k

                def cond(s):
                    return (s.status == S.RUNNING) & (s.k - k0 < chunk)

                return jax.lax.while_loop(
                    cond, lambda s: kernel.iteration(prob, s), st)

            init_fn = kernel.init_state_warm if warm else kernel.init_state
            init = _wrap(jax.vmap(init_fn))
            step = _wrap(jax.vmap(chunk_fn))

            def run(prob, *args):
                st = init(prob, *args)
                while bool(jax.device_get(jnp.any(st.status == S.RUNNING))):
                    st = step(prob, st)
                return st

            return run

        rescue = (opts.factorization_dtype
                  and opts.factorization_dtype != opts.dtype
                  and opts.precision_scheme == "two-phase")
        if not rescue:
            kernel = MPCKernel(opts)
            if stepped:
                self._solve = _stepped_run(kernel, False, _chunk_iters(opts))
            else:
                self._solve = _wrap(jax.vmap(kernel.solve_from))
            return

        # Mixed-precision rescue, batched (same scheme as the dense
        # driver): f32 lanes run with stall detection armed; if ANY lane
        # exits unconverged, every lane warm-restarts a full-precision
        # endgame in lockstep (converged lanes re-verify and exit within
        # an iteration or two).  Without this, one ill-conditioned lane
        # burns max_iter iterations for the whole batch.
        opts1 = dataclasses.replace(
            opts, stall_exit=opts.stall_exit if opts.stall_exit > 0 else 5,
            max_iter=min(opts.max_iter, opts.phase1_max_iter))
        opts2 = dataclasses.replace(opts, factorization_dtype="")
        kern2 = MPCKernel(opts2)
        if stepped:
            # The f64 rescue phase is the long pole, so it gets the
            # smallest chunk.
            phase1 = _stepped_run(MPCKernel(opts1), False, _chunk_iters(opts1))
            phase2 = _stepped_run(kern2, True, _chunk_iters(opts2))
        else:
            phase1 = _wrap(jax.vmap(MPCKernel(opts1).solve_from))
            phase2 = _wrap(jax.vmap(kern2.solve_from_warm))

        # Lane-shrunk rescue: the f64 phase re-runs EVERY lane in lockstep
        # even when only one or two failed f32 lanes need it.  Gather the
        # failed lanes, pad to a power-of-two lane count, run
        # the warm f64 phase on that small batch, and scatter the results
        # back.  One jitted program per rescue lane count (cached).
        _shrunk: dict = {}

        def _phase2_for(nl: int):
            if nl not in _shrunk:
                if stepped:
                    _shrunk[nl] = _stepped_run(
                        kern2, True, _chunk_iters(opts2, nl))
                else:
                    _shrunk[nl] = jax.jit(jax.vmap(kern2.solve_from_warm))
            return _shrunk[nl]

        # Host rescue (default, endgame 'auto'/'host' + native library +
        # unsharded batch): failed lanes re-solve on the host C++ LDL path
        # — the batched lanes are dense-padded SMALL instances, and a host
        # solve costs well under a second each, versus a warm f64 device
        # lockstep that effectively re-solves from scratch when a lane died
        # with STEP_ERROR at k~0.  solve_all() consumes the
        # per-instance override stats; the device state keeps the failed
        # lanes' phase-1 result.  endgame='f64' keeps the pure-device
        # rescue (lane-shrunk below).
        host_rescue = (opts.endgame in ("auto", "host")
                       and self.mesh is None)
        if host_rescue:
            from ..native import available

            host_rescue = available()

        def _host_rescue(bad):
            from ..solver.host import HostMPCSolver

            o = self.opts
            done = set()
            for i in bad:
                i = int(i)
                if i >= self.n_real or i in done:
                    continue  # batch-padding duplicate lane
                done.add(i)
                host = HostMPCSolver(
                    self.qps[i], tol=o.tol, max_iter=o.max_iter,
                    max_ncorr=o.max_ncorr, step_rule=o.step_rule,
                    regularization=o.regularization,
                    scaling=o.scaling,
                    max_gradient=o.max_gradient,
                    barrier_gate=o.barrier_gate, mu_min=o.mu_min,
                    bound_push=o.bound_push, bound_fac=o.bound_fac,
                    bound_relax_factor=o.bound_relax_factor,
                    print_level=max(o.print_level, 30),  # no banners
                )
                self._rescue_overrides[i] = host.solve()

        def _solve_rescue(prob, x0, y0, lb, ub):
            self._rescue_overrides = {}
            f1 = phase1(prob, x0, y0, lb, ub)
            statuses = np.asarray(jax.device_get(f1.status))
            bad = np.flatnonzero(statuses != S.SUCCESS)
            if bad.size == 0:
                return f1
            if host_rescue:
                _host_rescue(bad)
                return f1
            if self.mesh is not None or bad.size > statuses.size // 2:
                # Sharded batches (lanes span devices) and mostly-failed
                # batches keep the full-width lockstep rescue.
                f2 = phase2(prob, f1.x, f1.y, f1.zl, f1.zu, lb, ub)
                return f2._replace(k=f1.k + f2.k)
            nl = 1
            while nl < bad.size:
                nl *= 2
            idx = np.concatenate([bad, np.full(nl - bad.size, bad[0])])
            take = lambda t: jax.tree.map(lambda a: a[idx], t)  # noqa: E731
            f2 = _phase2_for(nl)(
                take(prob), f1.x[idx], f1.y[idx], f1.zl[idx], f1.zu[idx],
                lb[idx], ub[idx],
            )
            nb = bad.size
            merged = jax.tree.map(
                lambda full, part: full.at[bad].set(part[:nb]), f1, f2)
            return merged._replace(
                k=f1.k.at[bad].add(np.asarray(f2.k)[:nb]))

        self._solve = _solve_rescue

    def solve_batch(self):
        """Run all instances; returns the stacked final IPMState."""
        final = self._solve(self.prob, self.x0, self.y0, self.lb, self.ub)
        # Synchronize by fetching a reduced scalar rather than with
        # block_until_ready: the reduction's output is fully replicated, so
        # the fetch also works when final.k spans non-addressable devices
        # (multi-process meshes).
        jax.device_get(final.k.max())
        return final

    def solve_all(self) -> List[ExecutionStats]:
        """Solve and unpack per-instance ExecutionStats (real instances only)."""
        import time

        t0 = time.time()
        final = self.solve_batch()
        wall = time.time() - t0
        # Pull the (possibly sharded) final state to host before unpacking.
        if jax.process_count() > 1:
            # Global arrays span non-addressable devices: allgather them so
            # every process can unpack all instances.
            from jax.experimental import multihost_utils

            final = multihost_utils.process_allgather(final, tiled=True)
        else:
            final = jax.device_get(final)
        overrides = getattr(self, "_rescue_overrides", {})
        out = []
        for i in range(self.n_real):
            if i in overrides:
                # Host-rescued lane: the host solver's stats are already in
                # user coordinates (and its wall time was paid inside
                # solve_batch, so the batch wall above is consistent).
                out.append(overrides[i])
                continue
            info = self.infos[i]
            qp = self.qps[i]
            x_int = np.asarray(final.x[i], dtype=np.float64)[: info.n]
            y_int = np.asarray(final.y[i], dtype=np.float64)[: info.m]
            zl_int = np.asarray(final.zl[i], dtype=np.float64)[: info.n]
            zu_int = np.asarray(final.zu[i], dtype=np.float64)[: info.n]
            x_user = info.recover_x(x_int)
            y_user = info.recover_y(y_int)
            g_user = qp.grad(x_user)
            r_fix = g_user + qp.jtprod(y_user)
            zl_user = info.recover_z(zl_int, np.maximum(r_fix, 0.0))
            zu_user = info.recover_z(zu_int, np.maximum(-r_fix, 0.0))
            cnt = Counters(total_time=wall, k=int(final.k[i]))
            out.append(
                ExecutionStats(
                    status=_STATUS_MAP.get(int(final.status[i]), Status.INTERNAL_ERROR),
                    objective=float(qp.obj(x_user)),
                    solution=x_user,
                    constraints=qp.cons(x_user),
                    multipliers=y_user,
                    multipliers_L=zl_user,
                    multipliers_U=zu_user,
                    iter=int(final.k[i]),
                    counters=cnt,
                    primal_feas=float(final.inf_pr[i]),
                    dual_feas=float(final.inf_du[i]),
                    complementarity=float(final.inf_compl[i]),
                    options=self.opts,
                )
            )
        return out


def solve_batched(
    qps: Sequence[QuadraticProblem],
    mesh: Optional[Mesh] = None,
    **options,
) -> List[ExecutionStats]:
    """Convenience wrapper: batch-solve a list of QPs."""
    return BatchedMPCSolver.from_problems(qps, mesh=mesh, **options).solve_all()
