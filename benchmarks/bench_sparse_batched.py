"""Scenario-sweep throughput: batched sparse solves of one shared pattern.

Measures solve_sparse_batched (vmapped supernodal numeric phase, symbolic
shared) against the serial loop of single-instance sparse solves — the
production pattern for scenario sweeps / receding-horizon re-solves.

    python benchmarks/bench_sparse_batched.py --batch 16 --grid 40
    python benchmarks/bench_sparse_batched.py --batch 16 --n 2000 --m 1000
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
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--band", type=int, default=5)
    ap.add_argument("--grid", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--mixed-precision", action="store_true")
    ap.add_argument("--serial", action="store_true",
                    help="also time the serial single-instance loop")
    args = ap.parse_args()

    import jax


    import madqp_tpu as mq
    from madqp_tpu.parallel import solve_sparse_batched

    if args.grid:
        from madqp_tpu.models.generators import grid_lp

        qps = [grid_lp(g=args.grid, seed=s) for s in range(args.batch)]
        args.m, args.n = qps[0].ncon, qps[0].nvar
    else:
        qps = [mq.banded_sparse_lp(n=args.n, m=args.m, band=args.band, seed=s)
               for s in range(args.batch)]
    opts = dict(tol=args.tol, print_level=40)
    if args.mixed_precision:
        opts.update(factorization_dtype="float32", max_refine_steps=2)

    t0 = time.time()
    res = solve_sparse_batched(qps, **opts)
    first = time.time() - t0
    t0 = time.time()
    res = solve_sparse_batched(qps, **opts)
    warm = time.time() - t0
    solved = sum(r.status == mq.Status.SOLVE_SUCCEEDED for r in res)
    print(json.dumps({
        "metric": "sparse_batched_instances_per_s",
        "value": round(args.batch / warm, 2),
        "unit": "instances/s",
        "batch": args.batch, "n": args.n, "m": args.m,
        "solved": solved,
        "warm_s": round(warm, 3), "first_s": round(first, 3),
        "iters": [r.iter for r in res[:8]],
        "backend": jax.devices()[0].platform,
    }))

    if args.serial:
        t0 = time.time()
        for qp in qps:
            st = mq.solve_sparse_lp(qp, **opts)
        serial = time.time() - t0
        print(json.dumps({
            "metric": "sparse_serial_instances_per_s",
            "value": round(args.batch / serial, 2),
            "unit": "instances/s", "serial_s": round(serial, 3),
            "speedup_batched": round(serial / warm, 2),
        }))


if __name__ == "__main__":
    main()
