"""Differentiable-layer throughput benchmark (OptNet-style workload).

Measures batched `vmap(grad(loss ∘ qp_layer))` — the learning-to-optimize
inner step: solve B QPs and backpropagate a scalar loss of the solutions
through the KKT implicit function, all in one jitted program on the chip.
This workload has no analog in the reference (no AD story); it showcases
the capability cost: one extra K2 backsolve per instance on top of the
forward interior-point solve.

    python benchmarks/bench_diff.py --batch 256 --n 32 --m 12
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
    ap.add_argument("--m", type=int, default=12)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args()

    import jax

    import jax.numpy as jnp
    import numpy as np

    import madqp_tpu as mq

    n, m, B = args.n, args.m, args.batch
    rng = np.random.default_rng(0)
    M = rng.normal(size=(B, n, n))
    H = jnp.asarray(M @ M.transpose(0, 2, 1) + n * np.eye(n))
    c = jnp.asarray(rng.normal(size=(B, n)))
    A = jnp.asarray(rng.normal(size=(B, m, n)))
    xf = rng.normal(size=(B, n))
    b = jnp.einsum("bmn,bn->bm", A, jnp.asarray(xf))
    lb = jnp.asarray(xf - rng.uniform(0.05, 1.0, size=(B, n)))
    ub = jnp.asarray(xf + rng.uniform(0.05, 1.0, size=(B, n)))
    target = jnp.asarray(rng.normal(size=(B, n)))

    opts = dict(tol=args.tol, print_level=40)

    def loss(H, c, A, b, lb, ub, target):
        sol = mq.qp_layer(H, c, A, b, lb, ub, **opts)
        return jnp.sum((sol.x - target) ** 2)

    # grad wrt the "learnable" data (c and b — the OptNet parameterization)
    grad_fn = jax.jit(jax.vmap(jax.value_and_grad(loss, argnums=(1, 3))))

    t0 = time.time()
    (v, g) = jax.block_until_ready(grad_fn(H, c, A, b, lb, ub, target))
    compile_s = time.time() - t0

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        (v, g) = jax.block_until_ready(
            grad_fn(H, c, A, b, lb, ub, target))
    solve_s = (time.time() - t0) / reps

    print(json.dumps({
        "metric": "diff_qp_grads_per_s",
        "value": round(B / solve_s, 2),
        "unit": "grads/s",
        "detail": {
            "batch": B, "n": n, "m": m,
            "loss_mean": float(jnp.mean(v)),
            "gc_norm_mean": float(jnp.mean(jnp.linalg.norm(g[0], axis=-1))),
            "solve_s": round(solve_s, 4),
            "compile_s": round(compile_s, 2),
            "device": str(jax.devices()[0]),
        },
    }))


if __name__ == "__main__":
    main()
