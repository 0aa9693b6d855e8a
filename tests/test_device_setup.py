"""Device-independent checks of what the GPU smoke run relies on: backend
validation, the published-peak table, the compilation-cache rule, matmul
precision pinning, the native build key and the smoke script's own
references and GPU gate."""

import os
import subprocess
import sys
import types

import jax
import pytest

import madqp_tpu as mq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_unknown_linear_solver_rejected():
    """The removed Mosaic Cholesky backend's name is now an error that
    lists the valid backends."""
    removed = "PALLAS".lower()
    with pytest.raises(ValueError, match="'dense'.*'blocked'"):
        mq.solve(mq.simple_lp(), print_level=40, linear_solver=removed)


def test_chip_peaks_h100_row():
    from madqp_tpu.utils.roofline import chip_peaks

    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    p = chip_peaks(dev)
    assert (p.f64_tflops, p.f32_tflops, p.tf32_tflops, p.bf16_tflops,
            p.hbm_gbps) == (67.0, 67.0, 495.0, 989.0, 3350.0)


def test_chip_peaks_unknown_kind_raises():
    from madqp_tpu.utils.roofline import chip_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        chip_peaks(types.SimpleNamespace(device_kind="cpu"))


def test_roofline_report_uses_dtype_peak():
    from madqp_tpu.utils.roofline import roofline_report

    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    # 67 TFLOP in one second is exactly the f64 peak; 3.35 TB the HBM peak.
    rep = roofline_report(67e12, 3.35e12, 1.0, dtype="float64", device=dev)
    assert rep["flops_frac"] == pytest.approx(1.0)
    assert rep["hbm_frac"] == pytest.approx(1.0)
    rep = roofline_report(495e12, 0.0, 1.0, dtype="tf32", device=dev)
    assert rep["flops_frac"] == pytest.approx(1.0)


def _cache_dir_in_subprocess(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c",
         "import madqp_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("use_env", [True, False], ids=["env", "default"])
def test_compilation_cache_dir_rule(use_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins untouched; without it the cache sits
    at the fixed <checkout>/.jax_cache."""
    if use_env:
        env_dir = str(tmp_path / "cache")
        assert _cache_dir_in_subprocess(env_dir) == env_dir
    else:
        assert _cache_dir_in_subprocess(None) == os.path.join(
            REPO, ".jax_cache")


def test_dense_kernel_pins_highest_precision():
    """f32 factorizations must not run their products in TF32: every dot
    of the traced dense solve carries HIGHEST."""
    import jax.numpy as jnp

    from madqp_tpu.models.qp import build_standard_form
    from madqp_tpu.solver import state as S
    from madqp_tpu.solver.mpc import MPCKernel
    from madqp_tpu.utils.options import IPMOptions

    std, _, x0, y0 = build_standard_form(mq.random_qp(8, 4, seed=0))
    prob, lb, ub = S.problem_to_device(std, jnp.float64)
    kernel = MPCKernel(IPMOptions(factorization_dtype="float32",
                                  max_refine_steps=1))
    text = jax.jit(kernel.solve_from).lower(
        prob, jnp.asarray(x0), jnp.asarray(y0), lb, ub).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)


def test_native_library_keyed_on_source(tmp_path, monkeypatch):
    """An edited source builds (and loads) a new file, never a stale one."""
    import hashlib

    from madqp_tpu import native

    path = native.lib_path()
    with open(native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(path) == f"libmadqp_native-{digest}.so"
    src = tmp_path / "sparse_ldl.cpp"
    src.write_bytes(open(native._SRC, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native.lib_path() != path


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_r1_checker_accepts_solution_and_rejects_perturbed():
    import dataclasses

    qp = mq.random_qp(30, 12, seed=3, ineq=True)
    st = mq.solve(qp, tol=1e-8, print_level=40)
    assert st.status == mq.Status.SOLVE_SUCCEEDED
    chip_smoke.check_r1(qp, st)
    bad = dataclasses.replace(st, solution=st.solution + 1e-3)
    with pytest.raises(chip_smoke.CheckFailed, match="R1"):
        chip_smoke.check_r1(qp, bad)


def test_r1_checker_sees_wrong_multiplier_sign():
    qp = mq.random_qp(30, 12, seed=4, ineq=True)
    st = mq.solve(qp, tol=1e-8, print_level=40)
    res = chip_smoke.kkt_residuals(qp, st)
    assert max(res.values()) <= chip_smoke.R1_TOL
    flipped = chip_smoke.kkt_residuals(
        qp, type(st)(**{**st.__dict__, "multipliers": -st.multipliers}))
    assert flipped["dual"] > 1e-3


def test_highs_reference_matches_solver_on_lp():
    qp = mq.random_lp(40, 15, seed=1)
    st = mq.solve(qp, tol=1e-8, print_level=40)
    ref = chip_smoke.highs_objective(qp)
    chip_smoke.check_r2(float(st.objective), ref)
    with pytest.raises(chip_smoke.CheckFailed, match="R2"):
        chip_smoke.check_r2(ref * (1 + 1e-4) + 1e-4, ref)
