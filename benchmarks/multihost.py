"""Multi-host launcher for the distributed solvers (reference SURVEY §2.5:
the communication layer the reference lacks — jax.distributed + XLA
collectives instead of NCCL/MPI).

Run one process per GPU of one host, process k on card k, with explicit
flags:

    python benchmarks/multihost.py --coordinator localhost:1234 \
        --num-processes 4 --process-id 0 --mode schur

Each process initializes jax.distributed with only its own card visible
(a JAX process reserves most of every card it opens, so a second process
on the same card fails for want of memory), builds the global mesh spanning
all processes, and runs either the batched instance-parallel solve
(``batched``) or the scenario-sharded Schur two-stage solve (``schur``).
XLA inserts the collectives (NCCL over NVLink between the cards) from the
shardings; there is no hand-written communication code to configure.

Single-host smoke (8 virtual CPU devices):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/multihost.py --mode schur
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="", help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--mode", choices=["batched", "schur"], default="schur")
    ap.add_argument("--n-instances", type=int, default=0,
                    help="batched mode: QP instances (default 2/device)")
    ap.add_argument("--scenarios", type=int, default=0,
                    help="schur mode: scenario count (default 4/device)")
    args = ap.parse_args()

    import jax

    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_ids=[args.process_id],
        )

    import madqp_tpu as mq  # noqa: E402 (after distributed init)

    devices = jax.devices()
    n_dev = len(devices)
    if jax.process_index() == 0:
        print(f"mesh over {n_dev} devices across "
              f"{jax.process_count()} process(es)")

    if args.mode == "batched":
        from madqp_tpu.parallel import BatchedMPCSolver

        mesh = jax.make_mesh((n_dev,), ("batch",))
        k = args.n_instances or 2 * n_dev
        qps = [mq.dense_dummy_qp(32, 16, seed=i) for i in range(k)]
        solver = BatchedMPCSolver.from_problems(qps, mesh=mesh, print_level=40)
        t0 = time.time()
        stats = solver.solve_all()
        if jax.process_index() == 0:
            ok = sum(s.status == mq.Status.SOLVE_SUCCEEDED for s in stats)
            print(f"batched: {ok}/{len(stats)} solved in {time.time()-t0:.2f}s")
    else:
        from madqp_tpu.parallel import random_two_stage, solve_two_stage

        mesh = jax.make_mesh((n_dev,), ("scen",))
        N = args.scenarios or 4 * n_dev
        prob, lb, ub = random_two_stage(
            n0=16, ns=12, ms=8, m0=4, N=N, seed=0, qp=True
        )
        stats = solve_two_stage(prob, lb, ub, mesh=mesh, print_level=40)
        if jax.process_index() == 0:
            print(f"schur: {stats.status.name} iter {stats.iter} "
                  f"obj {stats.objective:.6f} "
                  f"({N} scenarios over {n_dev} devices, "
                  f"{stats.counters.total_time:.2f}s)")


if __name__ == "__main__":
    main()
