"""On-device sparse path benchmark (SPARSE_PLAN S3; SURVEY §7.3 #1).

Solves a large banded sparse LP with the fully on-device supernodal path
(solve_sparse_lp: COO matvecs + device-assembled normal equations +
level-scheduled batched Cholesky) and, for comparison, the host sparse
path (native C++ LDLᵀ per iteration).

    python benchmarks/bench_sparse_device.py --n 20000 --m 10000
    JAX_PLATFORMS=cpu python benchmarks/bench_sparse_device.py --n 4000 ...
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
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--m", type=int, default=10000)
    ap.add_argument("--band", type=int, default=5)
    ap.add_argument("--grid", type=int, default=0,
                    help="use a gxg 2D-grid LP instead of the banded LP "
                         "(wide-front etree — the batched-front regime)")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--kkt", choices=["normal", "augmented"],
                    default="normal")
    ap.add_argument("--mixed-precision", action="store_true")
    ap.add_argument("--refine", type=int, default=2)
    ap.add_argument("--order", default="auto")
    ap.add_argument("--solve-mode", default="chol", choices=["chol", "inverse"])
    ap.add_argument("--host", action="store_true",
                    help="also run the host sparse path for comparison")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()

    import jax


    import madqp_tpu as mq

    if args.grid:
        from madqp_tpu.models.generators import grid_lp

        qp = grid_lp(g=args.grid, seed=0)
        args.m, args.n = qp.ncon, qp.nvar
    else:
        qp = mq.banded_sparse_lp(n=args.n, m=args.m, band=args.band, seed=0)
    opts = dict(tol=args.tol, print_level=40)  # 40 = ERROR = quiet
    if args.mixed_precision:
        opts.update(factorization_dtype="float32",
                    max_refine_steps=args.refine)
    opts["solve_mode"] = args.solve_mode

    solver = (mq.solve_sparse_lp if args.kkt == "normal"
              else mq.solve_sparse_qp)

    t0 = time.time()
    st = solver(qp, order=args.order, **opts)
    first = time.time() - t0  # includes symbolic analysis + compile
    times = [first]
    for _ in range(args.repeat - 1):
        t0 = time.time()
        st = solver(qp, order=args.order, **opts)
        times.append(time.time() - t0)

    best = min(times)
    rec = {
        "metric": ("sparse_device_grid" if args.grid
                   else f"sparse_device_{args.kkt}"),
        "n": args.n, "m": args.m, "band": args.band,
        "status": int(st.status), "iter": st.iter,
        "objective": st.objective,
        "total_time_first": round(first, 3),
        "total_time_best": round(best, 3),
        "time_per_iter_ms": round(1e3 * best / max(st.iter, 1), 2),
        "primal_feas": st.primal_feas, "dual_feas": st.dual_feas,
        "mixed_precision": bool(args.mixed_precision),
        "solve_mode": args.solve_mode,
        "backend": jax.devices()[0].platform,
    }
    print(json.dumps(rec))

    if args.host:
        # normal-equations host KKT for LPs (the reference's CPU benchmark
        # config, scripts/benchmarks_cpu.jl:33-45); print_level=40 (ERROR)
        # is "quiet" — levels are logging thresholds, higher = less.
        t0 = time.time()
        sh = mq.solve_host(qp, tol=args.tol, print_level=40,
                           kkt_system="normal" if qp.is_lp else "k2")
        host_t = time.time() - t0
        print(json.dumps({
            "metric": "sparse_host_ldl", "n": args.n, "m": args.m,
            "status": int(sh.status), "iter": sh.iter,
            "objective": sh.objective, "total_time": round(host_t, 3),
            "time_per_iter_ms": round(1e3 * host_t / max(sh.iter, 1), 2),
        }))


if __name__ == "__main__":
    main()
