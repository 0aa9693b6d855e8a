"""GEMM-rich blocked dense factorizations for the supernodal numeric phase.

XLA's own batched `cholesky` / `triangular_solve` can lower to long
sequential column sweeps over the full panel.  Since the f64 endgame of
the two-phase sparse solver is factorization-bound, these replacements
restructure the same math so that all O(w^3) work lands in batched
matmuls and only O(w) steps of (nb, b, b) elementwise work stay
sequential (b = the 32-wide unblocked base).

Contents (all batched over arbitrary leading dims, last two dims w x w):
  * `unblocked_ldl`    — masked rank-1 sweep LDL^T (optionally sign-
    directed pivot flooring), the base case; same semantics as
    `sparse_chol.dense_ldl`.
  * `blocked_ldl`      — recursive block LDL^T built from the base case
    plus GEMM panel/trailing updates.
  * `blocked_cholesky` — SPD Cholesky via blocked_ldl (L_chol = L√d);
    drop-in for `jnp.linalg.cholesky` on lower-triangular use.
  * `inv_unit_lower` / `inv_lower` — blocked triangular inversion
    (explicit inverses turn every downstream panel solve into a matmul).

Reference context: the numeric phase these feed is the device equivalent of
cuDSS's factorization loop (scripts/benchmarks_gpu.jl:41-42); the
pivot-floor semantics mirror dense_ldl (cuDSS-style static pivoting).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BLK = 32


def unblocked_ldl(F, sgn=None, floor: float = 0.0):
    """No-pivot LDL^T of (..., w, w) symmetric matrices: F = L D L' with
    L unit lower triangular.  Sequential masked rank-1 sweep over the w
    columns — use only as the blocked base case (w <= ~32).

    With `sgn` ((..., w) expected pivot signs) and `floor` > 0, pivots
    are perturbed to sgn * max(sgn * d, floor)."""
    w = F.shape[-1]
    idx = jnp.arange(w)

    def body(j, carry):
        F, L, d = carry
        dj = F[..., j, j]
        if sgn is not None and floor > 0.0:
            sj = sgn[..., j]
            dj = sj * jnp.maximum(sj * dj, jnp.asarray(floor, F.dtype))
        col = F[..., :, j] / dj[..., None]
        col = jnp.where(idx > j, col, 0.0)
        F = F - dj[..., None, None] * col[..., :, None] * col[..., None, :]
        L = L.at[..., :, j].set(col)
        d = d.at[..., j].set(dj)
        return F, L, d

    L0 = jnp.zeros_like(F)
    d0 = jnp.zeros(F.shape[:-1], F.dtype)
    _, L, d = jax.lax.fori_loop(0, w, body, (F, L0, d0))
    L = L + jnp.eye(w, dtype=F.dtype)
    return L, d


def inv_unit_lower(L, blk: int = BLK):
    """Explicit inverse of a batched UNIT lower-triangular (..., w, w):
    blocked 2x2 recursion — inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]]
    — with a sequential row-sweep base case.  Large 2-D inputs dispatch
    to the right-looking panel_inv_unit_lower (O(1) program size)."""
    w = L.shape[-1]
    if L.ndim == 2 and w >= _PANEL_MIN:
        return panel_inv_unit_lower(L)
    if w > blk:
        h = blk * (((w + 1) // 2 + blk - 1) // blk)  # split at a blk multiple
        h = min(h, w - 1)
        iA = inv_unit_lower(L[..., :h, :h], blk)
        iC = inv_unit_lower(L[..., h:, h:], blk)
        B = L[..., h:, :h]
        off = -(iC @ (B @ iA))
        top = jnp.concatenate([iA, jnp.zeros_like(L[..., :h, h:])], axis=-1)
        bot = jnp.concatenate([off, iC], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)

    idx = jnp.arange(w)

    def body(i, X):
        # row i of inv: e_i - L[i, :i] @ X[:i, :]  (unit diagonal)
        li = jnp.where(idx < i, L[..., i, :], 0.0)            # (..., w)
        acc = jnp.einsum("...k,...kj->...j", li, X)
        row = jnp.where(idx == i, 1.0, 0.0) - acc
        return X.at[..., i, :].set(row)

    X0 = jnp.zeros_like(L)
    return jax.lax.fori_loop(0, w, body, X0)


def inv_lower(L, unit: bool = False, blk: int = BLK):
    """Explicit inverse of batched lower-triangular (..., w, w).
    Non-unit L = L_u @ diag(d)  =>  inv(L) = diag(1/d) @ inv(L_u)."""
    if unit:
        return inv_unit_lower(L, blk)
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    Lu = L / d[..., None, :]
    return inv_unit_lower(Lu, blk) / d[..., :, None]


PANEL = 256          # right-looking panel width for large matrices
OUTER = 2048         # outer stripe width of the two-level SPD path
_PANEL_MIN = 1024    # 2-D inputs at least this wide take the panel path


def _chol_block(D):
    """Cholesky + explicit inverse of one (w, w) SPD panel via XLA's
    native kernels (the recursive blocked LDL base that panel_ldl uses for
    the signed case is far slower at this width)."""
    Lp = jax.lax.linalg.cholesky(D)
    iLp = jax.lax.linalg.triangular_solve(
        Lp, jnp.eye(D.shape[-1], dtype=D.dtype), left_side=True, lower=True)
    return Lp, iLp


def panel_chol(F, panel: int = PANEL, outer: int = OUTER):
    """Two-level right-looking Cholesky for LARGE (n, n) SPD matrices:
    returns the lower NON-unit factor L with F = L L'.

    Level 1 (Python-unrolled, static shrinking shapes): stripes of
    `outer` columns; after a stripe is factored, ONE right-sized GEMM
    updates the trailing square.  Level 2 (lax.fori_loop, O(1) program
    per stripe): `panel`-column steps inside the stripe, each a native
    XLA cholesky + triangular inverse of the diagonal block plus a
    stripe-width masked rank-panel GEMM.

    Versus panel_ldl's one-level scheme this (a) replaces the 26.9 ms
    recursive base with 0.03 ms XLA panel kernels and (b) cuts the
    masked-GEMM waste from ~6x ideal flops to ~1.6x (masking is bounded
    by the stripe, the cross-stripe updates are exact).  Program size is
    O(n/outer) unrolled stripe bodies.

    NaN from a non-SPD input propagates through cholesky and is caught
    by the caller's factor_ok check (same contract as blocked_cholesky).
    """
    n = F.shape[-1]
    dtype = F.dtype
    Kp = -(-n // panel)
    npad = Kp * panel
    if npad != n:
        pad = npad - n
        F = jnp.pad(F, ((0, pad), (0, pad)))
        F = F.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)

    stripes = []          # (j0, width) static per stripe
    j0 = 0
    while j0 < npad:
        w = min(outer, npad - j0)
        stripes.append((j0, w))
        j0 += w

    def factor_stripe(S, h, w):
        """Factor the leading w columns of the (h, w) trailing stripe.
        Rows of stripe column c live at row index c (the stripe starts
        at the diagonal).  Returns the (h, w) factor block-column."""
        rows = jnp.arange(h)
        cols = jnp.arange(w)

        def body(ki, carry):
            S, Lst = carry
            c0 = ki * panel
            D = jax.lax.dynamic_slice(S, (c0, c0), (panel, panel))
            Lp, iLp = _chol_block(D)
            col = jax.lax.dynamic_slice(S, (0, c0), (h, panel))
            Z = col @ iLp.T
            below = (rows >= c0 + panel)[:, None]
            Zb = jnp.where(below, Z, jnp.zeros((), dtype))
            Lcol = jax.lax.dynamic_update_slice(Zb, Lp, (c0, 0))
            Lw = Lcol[:w]
            Lwb = jnp.where((cols >= c0 + panel)[:, None], Lw,
                            jnp.zeros((), dtype))
            S = S - Zb @ Lwb.T
            Lst = jax.lax.dynamic_update_slice(Lst, Lcol, (0, c0))
            return S, Lst

        L0 = jnp.zeros((h, w), dtype)
        if w == panel:  # single-panel stripe: skip the loop machinery
            _, Lst = body(0, (S, L0))
            return Lst
        _, Lst = jax.lax.fori_loop(0, w // panel, body, (S, L0))
        return Lst

    T = F
    blocks = []
    for j0, w in stripes:
        h = npad - j0
        Lst = factor_stripe(T[:, :w], h, w)
        blocks.append(Lst)
        if h > w:
            Lb = Lst[w:, :]
            T = T[w:, w:] - Lb @ Lb.T

    L = jnp.zeros((npad, npad), dtype)
    for (j0, w), Lst in zip(stripes, blocks):
        L = jax.lax.dynamic_update_slice(L, Lst, (j0, j0))
    return L[:n, :n]


def panel_inv_lower(L, unit: bool = False, panel: int = PANEL):
    """Explicit inverse of a LARGE (n, n) lower-triangular L (unit or
    not): block forward solve L X = I with native XLA triangular_solve
    panel bases and one masked rank-panel GEMM per fori_loop step."""
    n = L.shape[-1]
    K = -(-n // panel)
    npad = K * panel
    dtype = L.dtype
    if npad != n:
        pad = npad - n
        L = jnp.pad(L, ((0, pad), (0, pad)))
        L = L.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    rows = jnp.arange(npad)
    eye = jnp.eye(panel, dtype=dtype)

    def body(k, X):
        j0 = k * panel
        L11 = jax.lax.dynamic_slice(L, (j0, j0), (panel, panel))
        i11 = jax.lax.linalg.triangular_solve(
            L11, eye, left_side=True, lower=True, unit_diagonal=unit)
        Xk = i11 @ jax.lax.dynamic_slice(X, (j0, 0), (panel, npad))
        colL = jax.lax.dynamic_slice(L, (0, j0), (npad, panel))
        below = (rows >= j0 + panel)[:, None]
        colLm = jnp.where(below, colL, jnp.zeros((), dtype))
        X = X - colLm @ Xk
        return jax.lax.dynamic_update_slice(X, Xk, (j0, 0))

    X = jax.lax.fori_loop(0, K, body, jnp.eye(npad, dtype=dtype))
    return X[:n, :n]


def factor_inv_chol(Ms):
    """Factor an SPD (n, n) matrix and invert the CHOLESKY FACTOR:
    returns (L_chol, iL) with iL = L_chol^-1, so Ms^-1 r = iL' (iL r)
    is two matvecs.  The full inverse iL'iL is deliberately NOT formed —
    that n^3 GEMM costs about as much as the factorization itself.  A
    non-SPD input yields NaNs in L_chol's diagonal (factor_ok contract).

    Path choice (tuned on earlier hardware; awaits a sweep on the GPU):
    - f32 below the panel threshold: NATIVE XLA cholesky +
      triangular_solve; the GEMM-rich LDL recursion is latency-bound at
      small n.
    - f64 below the panel threshold keeps the GEMM-rich recursion.
    - large 2-D inputs of either dtype: the two-level panel path."""
    n = Ms.shape[-1]
    if Ms.ndim == 2 and n >= _PANEL_MIN:
        L = panel_chol(Ms)
        return L, panel_inv_lower(L)
    if Ms.dtype == jnp.float32:
        L = jax.lax.linalg.cholesky(Ms)
        eye = jnp.broadcast_to(jnp.eye(n, dtype=Ms.dtype), Ms.shape)
        iL = jax.lax.linalg.triangular_solve(
            L, eye, left_side=True, lower=True)
        return L, iL
    Lu, dd = blocked_ldl(Ms)
    sq = jnp.sqrt(dd)
    i11 = inv_unit_lower(Lu)
    return Lu * sq[None, :], i11 / sq[:, None]


def chol_explicit_inverse(Ms):
    """Factor an SPD (n, n) matrix and form its explicit inverse:
    returns (L_chol, Ms_inv).  Prefer factor_inv_chol unless the full
    inverse matrix itself is needed."""
    L, iL = factor_inv_chol(Ms)
    return L, iL.T @ iL


def panel_ldl(F, sgn=None, floor: float = 0.0, panel: int = PANEL):
    """Right-looking no-pivot LDL^T for LARGE (n, n) matrices: a fori_loop
    over n/panel column panels with STATIC shapes — the panel factorizes
    via the recursive blocked base and the trailing update is ONE
    full-width masked rank-panel GEMM per step.

    The masked update spends ~6x the ideal flop count (n^2*panel per step
    instead of the shrinking triangle), but they are matmul flops and
    the program is O(1) in n/panel — one compiled loop body — versus the
    recursion's O(n/blk) unrolled stages."""
    n = F.shape[-1]
    K = -(-n // panel)
    npad = K * panel
    dtype = F.dtype
    if npad != n:
        pad = npad - n
        F = jnp.pad(F, ((0, pad), (0, pad)))
        F = F.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
        if sgn is not None:
            sgn = jnp.concatenate([jnp.asarray(sgn, dtype),
                                   jnp.ones((pad,), dtype)])
    use_floor = sgn is not None and floor > 0.0
    sgn_arr = (jnp.asarray(sgn, dtype) if use_floor
               else jnp.ones((npad,), dtype))
    rows = jnp.arange(npad)

    def body(k, carry):
        W, L, d = carry
        j0 = k * panel
        colblk = jax.lax.dynamic_slice(W, (0, j0), (npad, panel))
        D11 = jax.lax.dynamic_slice(W, (j0, j0), (panel, panel))
        sg = jax.lax.dynamic_slice(sgn_arr, (j0,), (panel,))
        L11, d1 = blocked_ldl(D11, sgn=sg if use_floor else None,
                              floor=floor)
        i11 = jax.lax.linalg.triangular_solve(
            L11, jnp.eye(panel, dtype=dtype), left_side=True, lower=True,
            unit_diagonal=True)
        Z = colblk @ i11.T
        below = (rows >= j0 + panel)[:, None]
        Zm = jnp.where(below, Z, jnp.zeros((), dtype))
        L21 = Zm / d1[None, :]
        W = W - Zm @ L21.T
        colL = jax.lax.dynamic_update_slice(L21, L11, (j0, 0))
        L = jax.lax.dynamic_update_slice(L, colL, (0, j0))
        d = jax.lax.dynamic_update_slice(d, d1, (j0,))
        return W, L, d

    L0 = jnp.zeros((npad, npad), dtype)
    d0 = jnp.ones((npad,), dtype)
    _, L, d = jax.lax.fori_loop(0, K, body, (F, L0, d0))
    return L[:n, :n], d[:n]


def panel_inv_unit_lower(L, panel: int = PANEL):
    """Explicit inverse of a LARGE (n, n) unit lower-triangular L."""
    return panel_inv_lower(L, unit=True, panel=panel)


def blocked_ldl(F, sgn=None, floor: float = 0.0, blk: int = BLK):
    """Blocked no-pivot LDL^T of (..., w, w): same result as
    unblocked_ldl, but panel solves and trailing updates are GEMMs and
    only blk-column base sweeps stay sequential.  Large 2-D inputs
    dispatch to the right-looking panel_ldl (O(1) program size)."""
    w = F.shape[-1]
    if F.ndim == 2 and w >= _PANEL_MIN:
        return panel_ldl(F, sgn=sgn, floor=floor)
    if w <= blk:
        return unblocked_ldl(F, sgn=sgn, floor=floor)
    h = blk
    F11 = F[..., :h, :h]
    F21 = F[..., h:, :h]
    F22 = F[..., h:, h:]
    L11, d1 = unblocked_ldl(F11, sgn=None if sgn is None else sgn[..., :h],
                            floor=floor)
    i11 = inv_unit_lower(L11, blk)
    Z = F21 @ jnp.swapaxes(i11, -1, -2)        # Z = F21 L11^{-T}
    L21 = Z / d1[..., None, :]
    S22 = F22 - Z @ jnp.swapaxes(L21, -1, -2)
    L22, d2 = blocked_ldl(S22, sgn=None if sgn is None else sgn[..., h:],
                          floor=floor, blk=blk)
    top = jnp.concatenate([L11, jnp.zeros_like(F[..., :h, h:])], axis=-1)
    bot = jnp.concatenate([L21, L22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2), jnp.concatenate([d1, d2], axis=-1)


def blocked_cholesky(F, blk: int = BLK):
    """SPD Cholesky of (..., w, w) via blocked LDL^T: L_chol = L * sqrt(d).
    Drop-in for jnp.linalg.cholesky (lower), GEMM-rich.  No pivoting: the
    IPM's regularized normal/augmented systems keep pivots positive; NaN
    from a non-SPD input propagates and is caught by factor_ok.  Large
    2-D inputs take the two-level panel path."""
    if F.ndim == 2 and F.shape[-1] >= _PANEL_MIN:
        return panel_chol(F)
    L, d = blocked_ldl(F, blk=blk)
    return L * jnp.sqrt(d)[..., None, :]
