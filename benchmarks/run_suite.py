"""Benchmark suite runner emitting the reference's 9-column schema.

Equivalent of scripts/benchmarks_{cpu,gpu}.jl (reference SURVEY §6): per
instance records nvar, ncon, nnzj, nnzh, status, iter, objective,
total_time, linear_solver_time.  Instances come from a directory of
MPS/QPS files (``--dir``) or from built-in generated suites (``--suite``).

Usage:
    python benchmarks/run_suite.py --suite random_qp --sizes 100,200,500
    python benchmarks/run_suite.py --dir /path/to/netlib --out results.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import madqp_tpu as mq  # noqa: E402


def _load_guard(context, threshold=1.0, wait=False):
    """Record the 1-minute host load average before a timed section.

    Device compiles running beside a host baseline saturate the host's
    cores and inflate host wall times, so every timed solve records the
    pre-solve load and the run warns loudly when it exceeds `threshold`.  With wait=True the
    harness sleeps until the host quiets down (bounded at 10 min) so
    baseline timings are never taken on a contended machine.
    """
    load = os.getloadavg()[0]
    if wait:
        deadline = time.time() + 600
        while load > threshold and time.time() < deadline:
            print(f"# load-guard: load {load:.2f} > {threshold} before "
                  f"{context}; waiting for quiet host", file=sys.stderr)
            time.sleep(15)
            load = os.getloadavg()[0]
    if load > threshold:
        print(f"# LOAD WARNING: 1-min load {load:.2f} > {threshold} at "
              f"start of {context} — wall times may be inflated by "
              "contention; do not commit as a baseline", file=sys.stderr)
    return load


def run_instance(name, qp, options, repeat=1, quiet_load=False):
    """import -> presolve -> scale -> solve -> 9-column record
    (reference run_benchmark, scripts/benchmarks_cpu.jl:12-60).

    repeat > 1 re-solves the instance in-process and records the best wall
    as warm_time (same-pattern solves reuse the cached kernels/executables;
    the production number for sweeps)."""
    record = {
        "name": name,
        "nvar": qp.nvar,
        "ncon": qp.ncon,
        "nnzj": qp.nnzj,
        "nnzh": qp.nnzh,
        "status": -1,
        "iter": -1,
        "objective": float("nan"),
        "total_time": -1.0,
        "linear_solver_time": -1.0,
    }

    def dispatch(qp_s, solve_opts, backend):
        if backend == "host":
            return mq.solve_host(qp_s, **solve_opts)
        if backend == "sparse-device":
            # fully on-device sparse path: normal equations for LPs,
            # augmented LDL for QPs (solver/sparse_{lp,qp}.py)
            solve_opts = dict(solve_opts)
            solve_opts.pop("pad_mode", None)
            solve_opts.pop("kkt_system", None)
            skkt = solve_opts.pop("sparse_kkt", "auto")
            if qp_s.is_lp and skkt == "auto":
                return mq.solve_sparse_lp(qp_s, **solve_opts)
            # auto: diagonal-Hessian QPs ride the smaller SPD
            # normal-equations reduction; general H -> augmented LDL;
            # condensed = K1 slack/dual elimination (SPD n0 x n0)
            return mq.solve_sparse_qp(qp_s, kkt_system=skkt, **solve_opts)
        return mq.solve(qp_s, **solve_opts)

    try:
        backend = options.get("backend", "device")
        solve_opts = {k: v for k, v in options.items() if k != "backend"}
        qp_p, pinfo, ok = mq.presolve_qp(qp)
        if not ok:
            record["status"] = f"presolve:{pinfo.status.value}"
            if pinfo.status.value == "solved":
                # fully reduced: presolve determined the solution
                import numpy as _np
                x = pinfo.postsolve_x(_np.zeros(0))
                record["objective"] = float(qp.obj(x))
                record["iter"] = 0
            return record
        qp_s, scaling = mq.scale_qp(qp_p)
        record["load_1min"] = _load_guard(f"solve of {name}",
                                          wait=quiet_load)
        t0 = time.time()
        stats = dispatch(qp_s, solve_opts, backend)
        record["total_time"] = time.time() - t0
        stats = mq.unscale_stats(scaling, stats)
        record["status"] = int(stats.status == mq.Status.SOLVE_SUCCEEDED)
        # Distinguish "certified infeasible/unbounded" from a bare failure
        # (the 0/1 column mirrors the reference's success flag,
        # scripts/tables/generate_tables.jl:66-68).
        record["status_detail"] = stats.status.name
        record["iter"] = stats.iter
        record["objective"] = stats.objective
        # Honest schema: the reference's linear_solver_time column
        # (scripts/benchmarks_cpu.jl:55) is only emitted when it was
        # actually measured — a 0.0 placeholder reads as "free".
        ls_t = stats.counters.linear_solver_time
        record["linear_solver_time"] = (
            ls_t if (options.get("measure_linear_solver") or ls_t > 0.0)
            else None)
        # Hybrid share: seconds of the solve spent in the two-phase
        # endgame and which backend ran it ("host" = host-CPU work inside
        # a nominally-device solve).
        eg_t = getattr(stats.counters, "endgame_time", 0.0)
        if eg_t:
            record["endgame_time"] = eg_t
            record["endgame_backend"] = getattr(
                stats.counters, "endgame_backend", "")
        if repeat > 1 and record["status"] == 1:
            walls = []
            for _ in range(1, repeat):
                record["load_1min"] = _load_guard(
                    f"warm re-solve of {name}", wait=quiet_load)
                tw = time.time()
                stats_w = dispatch(qp_s, solve_opts, backend)
                walls.append(time.time() - tw)
                if walls[-1] == min(walls):
                    # endgame share of the BEST warm re-solve (the wall
                    # the ratios are computed from), not the cold run
                    eg_w = getattr(stats_w.counters, "endgame_time", 0.0)
                    if eg_w:
                        record["endgame_time"] = eg_w
                        record["endgame_backend"] = getattr(
                            stats_w.counters, "endgame_backend", "")
            record["warm_time"] = min(walls)
    except Exception as e:  # mirror the harness's record-and-continue policy
        record["status"] = f"error:{type(e).__name__}"
    return record


def generated_suite(kind: str, sizes, families=()):
    if kind.startswith("structured"):
        from madqp_tpu.models.suite import structured_suite

        size = kind.split(":")[1] if ":" in kind else "medium"
        yield from structured_suite(size, families=tuple(families))
        return
    for n in sizes:
        m = max(1, n // 2)
        if kind == "random_qp":
            yield f"random_qp_{n}", mq.random_qp(n, m, seed=n)
        elif kind == "random_lp":
            yield f"random_lp_{n}", mq.random_lp(n, m, seed=n)
        elif kind == "dense_dummy":
            yield f"dense_dummy_{n}", mq.dense_dummy_qp(n, m, seed=n)
        else:
            raise ValueError(f"unknown suite {kind}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", help="directory of .mps/.qps/.sif[.gz|.bz2] files")
    ap.add_argument("--suite", default="random_qp",
                    help="random_qp | random_lp | dense_dummy | "
                         "structured[:small|medium|large|xlarge] (Netlib-like "
                         "family mix, models/suite.py)")
    ap.add_argument("--sizes", default="100,200,500")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-iter", type=int, default=300)
    ap.add_argument("--max-ncorr", type=int, default=3)
    ap.add_argument("--kkt", default="condensed")
    ap.add_argument("--linear-solver", default="dense",
                    choices=["dense", "blocked"],
                    help="dense-path factorization backend (blocked = "
                         "GEMM-rich LDL + explicit inverses)")
    ap.add_argument("--backend",
                    choices=["device", "host", "sparse-device"],
                    default="device",
                    help="device = jitted dense path; host = sparse "
                         "native-LDL CPU path; sparse-device = on-device "
                         "supernodal sparse path (large instances)")
    ap.add_argument("--sparse-kkt", default="auto",
                    choices=["auto", "augmented", "normal", "condensed"],
                    help="KKT formulation for --backend=sparse-device")
    ap.add_argument("--mixed-precision", action="store_true",
                    help="f32 factorization + f64 refinement (device path)")
    ap.add_argument("--endgame", default="",
                    choices=["", "auto", "f64", "krylov", "host"],
                    help="two-phase endgame for --backend=sparse-device "
                         "--mixed-precision ('host' skips the f64 XLA "
                         "compile entirely; see utils/options.py)")
    ap.add_argument("--measure-ls", action="store_true",
                    help="measure linear_solver_time (extra timed "
                         "factorize/backsolve after each solve)")
    ap.add_argument("--batched", action="store_true",
                    help="solve the whole suite as ONE vmapped batch "
                         "(single compile, lockstep iterations)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-solve each instance/bucket in-process "
                         "this many times total and "
                         "record the best warm wall time as warm_time")
    ap.add_argument("--out", default="")
    ap.add_argument("--resume", action="store_true",
                    help="checkpoint/resume: skip instances already recorded "
                         "in --out and append new results (SURVEY §5.4)")
    ap.add_argument("--exclude", default="", help="comma-separated instance names")
    ap.add_argument("--families", default="",
                    help="restrict --suite structured:* to these comma-"
                         "separated family names (models/suite.py _MAKERS); "
                         "with --resume this lets per-family backend choices "
                         "accumulate into one --out file")
    ap.add_argument("--quiet-load", action="store_true",
                    help="wait (up to 10 min) for the 1-min host load to "
                         "drop below 1.0 before every timed solve; always "
                         "recorded per-instance as load_1min either way")
    ap.add_argument("--exclude-preset", default="", choices=["", "netlib", "mm"],
                    help="concrete exclusion list for the real suites "
                         "(fetch_suites.EXCLUSIONS; reference "
                         "scripts/excluded_problems.jl)")
    ap.add_argument("--platform", default="",
                    help="force the jax platform; --backend host defaults "
                         "to 'cpu' so host-path suite runs leave the "
                         "accelerator to other processes")
    args = ap.parse_args()

    platform = args.platform or ("cpu" if args.backend == "host" else "")
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)

    options = dict(
        print_level=40,
        tol=args.tol,
        max_iter=args.max_iter,
        max_ncorr=args.max_ncorr,
        kkt_system=args.kkt,
        linear_solver=args.linear_solver,
        step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8),
        backend=args.backend,
    )
    if args.backend == "sparse-device":
        options["sparse_kkt"] = args.sparse_kkt
    if args.backend == "device":
        # Bucketed padding: ragged suites share compiled executables.
        options["pad_mode"] = "bucket"
    if args.mixed_precision:
        options.update(factorization_dtype="float32", max_refine_steps=1)
    if args.endgame and args.backend == "sparse-device":
        options["endgame"] = args.endgame
    if args.measure_ls:
        options["measure_linear_solver"] = True
    excluded = set(filter(None, args.exclude.split(",")))
    if args.exclude_preset:
        from fetch_suites import EXCLUSIONS

        excluded |= set(EXCLUSIONS[args.exclude_preset])

    instances = []
    if args.dir:
        patterns = ["*.mps", "*.qps", "*.sif", "*.SIF", "*.mps.gz", "*.mps.bz2",
                    "*.SIF.gz", "*.sif.gz"]
        files = sorted(
            f for pat in patterns for f in glob.glob(os.path.join(args.dir, pat))
        )
        for path in files:
            nm = os.path.basename(path).split(".")[0]
            if nm in excluded:
                continue
            try:
                instances.append((nm, mq.read_mps(path)))
            except Exception as e:
                print(json.dumps({"name": nm, "status": f"read_error:{e}"}))
    else:
        sizes = [int(s) for s in args.sizes.split(",")]
        families = tuple(filter(None, args.families.split(",")))
        if families and not args.suite.startswith("structured"):
            ap.error(f"--families only applies to --suite structured:*, "
                     f"not {args.suite!r}")
        instances = [
            (nm, qp) for nm, qp in generated_suite(args.suite, sizes, families)
            if nm not in excluded
        ]

    results = []
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {r["name"] for r in results}
        instances = [(nm, qp) for nm, qp in instances if nm not in done]
        print(f"# resume: {len(done)} done, {len(instances)} remaining",
              file=sys.stderr)

    def _checkpoint():
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=2)
            os.replace(tmp, args.out)

    if args.batched and instances:
        from madqp_tpu.parallel import BatchedMPCSolver

        solve_opts = {k: v for k, v in options.items()
                      if k not in ("backend", "pad_mode")}

        # Group instances into power-of-two size buckets and run one
        # lockstep batch per bucket: padding every lane to the single
        # largest instance wastes MXU work quadratically (a 121-var lane
        # padded to 2300 does ~360x the flops it needs) and can exceed
        # device memory on wide suites.
        def _bucket(v, lo=32):
            b = lo
            while b < v:
                b *= 2
            return b

        groups: dict = {}
        for nm, qp in instances:
            key = _bucket(qp.nvar + qp.ncon)
            groups.setdefault(key, []).append((nm, qp))
        for key in sorted(groups):
            batch = groups[key]
            load = _load_guard(f"batched bucket {key}",
                               wait=args.quiet_load)
            t0 = time.time()
            solver = BatchedMPCSolver.from_problems(
                [qp for _, qp in batch], **solve_opts)
            stats = solver.solve_all()
            total = time.time() - t0
            # True warm wall time: re-solve the same compiled bucket batch
            # in-process (fresh processes re-pay trace+compile).  This is
            # the number that matters for production sweeps /
            # receding-horizon use.
            warm = None
            if args.repeat > 1:
                walls = []
                for _ in range(1, args.repeat):
                    tw = time.time()
                    # solve_batch synchronizes via device_get (batched.py)
                    solver.solve_batch()
                    walls.append(time.time() - tw)
                warm = min(walls)
            warm_s = f", {warm:.3f}s warm" if warm is not None else ""
            print(f"# bucket {key}: {len(batch)} instances, "
                  f"{total:.2f}s cold{warm_s}", file=sys.stderr)
            for (nm, qp), st in zip(batch, stats):
                rec = {
                    "name": nm, "nvar": qp.nvar, "ncon": qp.ncon,
                    "nnzj": qp.nnzj, "nnzh": qp.nnzh,
                    "status": int(st.status == mq.Status.SOLVE_SUCCEEDED),
                    "iter": st.iter, "objective": st.objective,
                    "total_time": total,  # shared bucket-batch wall time
                    "warm_time": warm,    # shared in-process warm re-solve
                    "linear_solver_time": None,  # not measured in batched mode
                    "load_1min": load,
                }
                results.append(rec)
                print(json.dumps(rec), flush=True)
            _checkpoint()
    else:
        for nm, qp in instances:
            rec = run_instance(nm, qp, options, repeat=args.repeat,
                               quiet_load=args.quiet_load)
            results.append(rec)
            print(json.dumps(rec), flush=True)
            _checkpoint()  # per-instance: a killed run resumes with --resume

    _checkpoint()
    solved = sum(1 for r in results if r["status"] == 1)
    print(f"# solved {solved}/{len(results)}", file=sys.stderr)


if __name__ == "__main__":
    main()
