"""Batched-instance throughput benchmark (BASELINE config #4:
"1024 MPC-style instances vmapped per chip, sharded over pod slice").

Solves B random MPC-style dense QPs in lockstep via the vmapped solver and
reports instances/second.  On a multi-device mesh the batch shards
(data-parallel); single-chip runs exercise pure vmap throughput.

    python benchmarks/bench_batched.py --batch 256 --n 32 --m 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the batch over all devices")
    ap.add_argument("--mixed-precision", action="store_true")
    args = ap.parse_args()

    import jax

    import madqp_tpu as mq
    from madqp_tpu.parallel import BatchedMPCSolver

    opts = dict(print_level=40, tol=args.tol,
                step_rule=mq.AdaptiveStep(0.995),
                regularization=mq.FixedRegularization(1e-8, -1e-8))
    if args.mixed_precision:
        opts.update(factorization_dtype="float32", max_refine_steps=1)

    mesh = None
    if args.mesh and len(jax.devices()) > 1:
        mesh = jax.make_mesh((len(jax.devices()),), ("batch",))

    qps = [mq.dense_dummy_qp(args.n, args.m, seed=i) for i in range(args.batch)]
    t0 = time.time()
    solver = BatchedMPCSolver.from_problems(qps, mesh=mesh, **opts)
    build_s = time.time() - t0

    # warm-up (compile)
    t0 = time.time()
    final = solver.solve_batch()
    compile_s = time.time() - t0
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        final = solver.solve_batch()
    solve_s = (time.time() - t0) / reps
    statuses = [int(s) for s in final.status[: solver.n_real]]
    n_ok = sum(s == 1 for s in statuses)
    iters = [int(k) for k in final.k[: solver.n_real]]

    print(json.dumps({
        "metric": "batched_qp_instances_per_s",
        "value": round(args.batch / solve_s, 2),
        "unit": "instances/s",
        "detail": {
            "batch": args.batch,
            "n": args.n,
            "m": args.m,
            "solved": n_ok,
            "max_iters": max(iters),
            "solve_s": round(solve_s, 4),
            "compile_s": round(compile_s, 2),
            "build_s": round(build_s, 2),
            "devices": len(jax.devices()),
            "mesh": bool(mesh),
        },
    }))


if __name__ == "__main__":
    main()
