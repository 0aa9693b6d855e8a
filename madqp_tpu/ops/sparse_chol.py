"""Supernodal multifrontal sparse Cholesky on device (SPARSE_PLAN S1+S2).

The on-device answer to SURVEY §7.3 hard part #1 ("sparse symmetric
factorization on the device — nothing exists off-the-shelf").  Strategy:

  * host symbolic (once per pattern): fill-reducing ordering + elimination
    tree + exact factor structure (via the native C++ layer), fundamental
    supernode partition, and *static index maps* for every front — the
    A-scatter map and the child extend-add maps;
  * device numeric (every IPM iteration): a traced Python loop over
    supernodes in postorder; each front is a DENSE (r, r) matrix — assemble
    (scatter-add), extend-add children, factor the leading (w, w) block
    (Cholesky), panel triangular solve, Schur-complement update.  All
    shapes static; all irregularity lives in precomputed gather indices.

This is the prototype (unrolled trace, one front at a time).  The
production step (SPARSE_PLAN S3) buckets same-shape fronts per elimination
level and vmaps them — the numeric code below is already structured
per-front to make that swap mechanical.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from .blocked_dense import blocked_ldl, inv_unit_lower


class ScheduleTooLargeError(RuntimeError):
    """The flat scatter-map supernodal schedule would exceed the update-
    traffic cap (MADQP_MAX_UPDATE_ENTRIES) — the fill pattern needs a
    hierarchical multifrontal numeric phase; callers fall back to the
    host sparse path."""


@dataclasses.dataclass
class Supernode:
    cols: np.ndarray        # global (permuted) column indices, width w
    rows: np.ndarray        # full row structure incl. diagonal block, size r
    parent: int             # parent supernode id or -1
    # Assembly: scatter of A's upper-triangle entries into the (r, r) front.
    a_src: np.ndarray       # indices into the permuted upper-CSC value array
    a_dst: np.ndarray       # flat positions into the front (r*r)
    # Extend-add: for each child, positions of its update matrix in this front.
    child_ids: List[int]
    child_dst: List[np.ndarray]  # flat positions (uc*uc entries each)


@dataclasses.dataclass
class SupernodalSymbolic:
    n: int
    perm: np.ndarray
    iperm: np.ndarray
    supernodes: List[Supernode]
    Up: np.ndarray          # permuted upper-CSC structure (for value refill)
    Ui: np.ndarray
    max_width: int

    def permute_values(self, A: sp.spmatrix) -> np.ndarray:
        """Upper-triangle value array of P A P' in the stored CSC order."""
        Ap = sp.csc_matrix(A)[self.perm][:, self.perm]
        U = sp.triu(Ap.tocsr(), k=0, format="csc").sorted_indices()
        return np.asarray(U.data, dtype=np.float64)


def analyze(A: sp.spmatrix, order: str = "auto",
            max_supernode: int = 128, relax: int = 16) -> SupernodalSymbolic:
    """Host symbolic analysis of the SPD pattern of A.

    Supernodes use *relaxed amalgamation*: column j joins the running
    supernode when it is its elimination-tree parent and the merge adds at
    most `relax` padded rows to the panel.  Fundamental supernodes alone
    degenerate to width 1 on banded/chain patterns (struct(j-1) is never
    exactly {j} ∪ struct(j)); relaxation recovers the wide dense panels
    the batched dense fronts need — on a banded matrix the merge is exact (zero fill) and
    panels reach max_supernode width.
    """
    from ..native import SparseLDL, etree as _etree, ordering, postorder

    A = sp.csc_matrix(A)
    n = A.shape[0]
    perm0 = ordering(A, order)
    # Postorder the elimination tree so supernode columns are contiguous
    # and children precede parents (multifrontal traversal requirement).
    Aperm0 = A[perm0][:, perm0].tocsc()
    parent0 = _etree(Aperm0)
    post = postorder(parent0)
    perm = np.asarray(perm0)[post]

    # Exact factor structure from the native symbolic+numeric machinery
    # (numeric on a made-SPD proxy materializes Li in final order).
    Aperm = A[perm][:, perm].tocsc()
    proxy = Aperm.copy()
    proxy = (abs(proxy) + abs(proxy).T).tocsc()
    proxy = proxy + (abs(proxy).sum(axis=1).A1.max() + 1.0) * sp.eye(n)
    fs = SparseLDL(proxy, use_amd=False)
    ok = fs.factorize(proxy)
    assert ok, "symbolic proxy factorization failed"
    Lp, Li, Lnz = fs.Lp, fs.Li, fs.Lnz
    parent = np.asarray(_etree(Aperm))

    # column structures (strictly lower) of L
    col_rows = [np.sort(Li[Lp[j]: Lp[j] + Lnz[j]]) for j in range(n)]

    # Relaxed supernode partition.  B tracks the running panel's
    # strictly-below row set (as a python set for cheap union/diff).
    sn_start = [0]
    B = set(int(r) for r in col_rows[0]) if n else set()
    for j in range(1, n):
        chain = parent[j - 1] == j and (j - sn_start[-1]) < max_supernode
        if chain:
            newB = (B - {j}) | set(int(r) for r in col_rows[j])
            if len(newB) - col_rows[j].size <= relax:
                B = newB
                continue
        sn_start.append(j)
        B = set(int(r) for r in col_rows[j])
    sn_start.append(n)

    U = sp.triu(Aperm.tocsr(), k=0, format="csc").sorted_indices()
    Up = U.indptr.astype(np.int64)
    Ui = U.indices.astype(np.int32)

    # map column -> supernode id
    nsn = len(sn_start) - 1
    col_sn = np.empty(n, np.int32)
    for s in range(nsn):
        col_sn[sn_start[s]: sn_start[s + 1]] = s

    # Bottom-up row structures: a supernode's below set is the union of its
    # member columns' structures AND its children's update rows — with
    # amalgamated (padded) panels the update can carry rows absent from the
    # exact parent structure, so the union is required for the extend-add
    # maps to stay total.  Processing by ascending first column is
    # topological (postordered etree: children's columns precede parents').
    snodes: List[Supernode] = []
    pending: List[List[int]] = [[] for _ in range(nsn)]  # child ids per snode
    below_sets: List[np.ndarray] = [None] * nsn
    for s in range(nsn):
        j0, j1 = sn_start[s], sn_start[s + 1]
        rows = set()
        for i in range(j0, j1):
            rows.update(int(r) for r in col_rows[i])
        for c in pending[s]:
            rows.update(int(r) for r in below_sets[c])
        rows.difference_update(range(j0, j1))
        below = np.asarray(sorted(rows), np.int64)
        below_sets[s] = below
        cols = np.arange(j0, j1)
        all_rows = np.concatenate([cols, below]).astype(np.int64)
        snodes.append(Supernode(cols=cols, rows=all_rows, parent=-1,
                                a_src=None, a_dst=None,
                                child_ids=[], child_dst=[]))
        if below.size:
            p = int(col_sn[below[0]])
            snodes[s].parent = p
            pending[p].append(s)

    for s in range(nsn):
        snodes[s].child_ids = pending[s]

    # A-assembly maps.  An upper entry (i, j), i <= j, is the lower entry
    # (j, i) of column i, so it is assembled in the front of snode(i) at
    # local position (loc[j], loc[i]) — j is guaranteed to be in that
    # front's row structure (A's column pattern is a subset of L's).
    locs = [
        {int(g): k for k, g in enumerate(sn.rows)} for sn in snodes
    ]
    src_lists: List[List[int]] = [[] for _ in snodes]
    dst_lists: List[List[int]] = [[] for _ in snodes]
    for j in range(n):
        for p in range(Up[j], Up[j + 1]):
            i = int(Ui[p])  # i <= j
            s = int(col_sn[i])
            loc = locs[s]
            r = snodes[s].rows.size
            a, b = loc[j], loc[i]
            if a < b:
                a, b = b, a
            src_lists[s].append(p)
            dst_lists[s].append(a * r + b)
    for s, sn in enumerate(snodes):
        sn.a_src = np.asarray(src_lists[s], np.int64)
        sn.a_dst = np.asarray(dst_lists[s], np.int64)

    # extend-add maps: child update rows = child.rows[wc:] — all appear in
    # the parent's row set (by the etree property, possibly spread).
    # Incremental feasibility guard (laplqp post-mortem): these
    # flat uc^2-entry maps are where high-fill patterns (2-D-grid ND
    # factorizations) first explode — the 22.5k Laplacian ate >26M
    # entries on a SINGLE supernode and >55 GB in total before the OOM
    # killer fired.  Track the running total and fail fast with a typed
    # error the drivers turn into a clean host-path fallback.
    import os as _os

    _cap = int(float(_os.environ.get("MADQP_MAX_UPDATE_ENTRIES", 2.5e8)))
    _child_entries = 0
    for s, sn in enumerate(snodes):
        loc = {int(g): k for k, g in enumerate(sn.rows)}
        for c in sn.child_ids:
            ch = snodes[c]
            urows = ch.rows[ch.cols.size:]
            # positions of each (i, j) pair of the child's update (uc x uc,
            # lower triangle mirrored like above)
            uc = urows.size
            _child_entries += uc * uc
            if _child_entries > _cap:
                raise ScheduleTooLargeError(
                    f"supernodal extend-add maps exceed "
                    f"MADQP_MAX_UPDATE_ENTRIES={_cap:.2e} (running total "
                    f"{_child_entries:.2e} at supernode {s}/{len(snodes)});"
                    " this fill pattern needs a hierarchical multifrontal"
                    " numeric phase (use the host path)")
            lidx = np.asarray([loc[int(g)] for g in urows], np.int64)
            grid_a = np.repeat(lidx, uc)
            grid_b = np.tile(lidx, uc)
            a = np.maximum(grid_a, grid_b)
            b = np.minimum(grid_a, grid_b)
            r = sn.rows.size
            sn.child_dst.append(a * r + b)

    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    return SupernodalSymbolic(
        n=n, perm=np.asarray(perm, np.int64), iperm=iperm,
        supernodes=snodes, Up=Up, Ui=Ui,
        max_width=max(sn.cols.size for sn in snodes),
    )


def factorize(symb: SupernodalSymbolic, a_values):
    """Device numeric factorization: returns the list of L panels (r, w)
    per supernode (a pytree — jit/vmap friendly).

    Each front F (r, r) uses only its lower triangle; the update matrix
    passed to the parent is the trailing (r-w, r-w) Schur complement.
    """
    panels = [None] * len(symb.supernodes)
    updates = [None] * len(symb.supernodes)
    for s, sn in enumerate(symb.supernodes):  # postorder by construction
        r = sn.rows.size
        w = sn.cols.size
        F = jnp.zeros((r * r,), a_values.dtype)
        F = F.at[sn.a_dst].add(a_values[sn.a_src])
        for c, dst in zip(sn.child_ids, sn.child_dst):
            # Only the lower triangle: the mirrored position map would
            # double-count symmetric off-diagonal pairs otherwise.
            F = F.at[dst].add(jnp.tril(updates[c]).reshape(-1))
            updates[c] = None
        F = F.reshape(r, r)
        # symmetrize the lower-stored front
        F = jnp.tril(F) + jnp.tril(F, -1).T
        F11 = F[:w, :w]
        L11 = jsl.cholesky(F11, lower=True)
        if r > w:
            L21 = jsl.solve_triangular(L11, F[w:, :w].T, lower=True).T
            U = F[w:, w:] - L21 @ L21.T
            updates[s] = U
            panels[s] = jnp.concatenate([L11, L21], axis=0)
        else:
            updates[s] = jnp.zeros((0, 0), a_values.dtype)
            panels[s] = L11
    return panels


def solve(symb: SupernodalSymbolic, panels, b):
    """Solve A x = b given the supernodal factor panels."""
    x = jnp.asarray(b)[symb.perm]
    # forward: L y = b
    for s, sn in enumerate(symb.supernodes):
        w = sn.cols.size
        P = panels[s]
        xj = jsl.solve_triangular(P[:w, :], x[sn.cols], lower=True)
        x = x.at[sn.cols].set(xj)
        if sn.rows.size > w:
            x = x.at[sn.rows[w:]].add(-(P[w:, :] @ xj))
    # backward: L' x = y
    for s in range(len(symb.supernodes) - 1, -1, -1):
        sn = symb.supernodes[s]
        w = sn.cols.size
        P = panels[s]
        rhs = x[sn.cols]
        if sn.rows.size > w:
            rhs = rhs - P[w:, :].T @ x[sn.rows[w:]]
        x = x.at[sn.cols].set(
            jsl.solve_triangular(P[:w, :].T, rhs, lower=False)
        )
    return x[symb.iperm]


class DeviceSparseCholesky:
    """Convenience wrapper: analyze once, refactorize values per iteration."""

    def __init__(self, A: sp.spmatrix, order: str = "auto",
                 max_supernode: int = 128):
        self.symb = analyze(A, order=order, max_supernode=max_supernode)
        self._factorize = jax.jit(lambda v: factorize(self.symb, v))

    def factorize(self, A: sp.spmatrix):
        vals = jnp.asarray(self.symb.permute_values(A))
        self.panels = self._factorize(vals)
        return self

    def solve(self, b):
        return solve(self.symb, self.panels, b)

    @property
    def n_supernodes(self) -> int:
        return len(self.symb.supernodes)


# ---------------------------------------------------------------------------
# SPARSE_PLAN S3: level-scheduled, shape-bucketed batched numeric phase.
#
# The prototype above traces one dense front per supernode — compile time
# (and XLA program size) grows linearly with the supernode count.  The
# batched phase walks a SCHEDULE of two item kinds:
#
#   * _Bucket — supernodes of one elimination-tree level sharing a padded
#     (width, update) shape, processed as ONE batched Cholesky/LDL +
#     triangular solve + Schur matmul on a (L, r_pad, r_pad) tensor;
#   * _Chain  — a maximal single-child PATH in the assembly tree with a
#     constant padded shape, processed as ONE `lax.scan` whose carry is the
#     running Schur update.  Without this, path-shaped etrees (banded /
#     arrow / trajectory-QP patterns) emit one XLA stage per supernode —
#     a 160-level chain at n=20k failed to compile in 25 minutes; as a
#     scan it is a single stage regardless of length.
#
# All irregularity is precomputed host-side as static (or scan-stacked)
# gather/scatter index arrays; cross-item Schur updates flow through a flat
# `upd_buf` device array with static per-supernode offsets (deterministic
# scatter-add — SURVEY §5.2's lesson, no atomics).
# ---------------------------------------------------------------------------


def _pad_pow2(v: int, lo: int = 8) -> int:
    b = lo
    while b < v:
        b *= 2
    return b


def _pad_class(v: int, lo: int = 8) -> int:
    """Coarse pad classes: powers of 4 from 8 (8, 32, 128, 512), then
    powers of 2.  Fewer distinct front shapes means fewer XLA stages —
    same-shape rounds merge and consecutive rounds scan-group — and the
    extra padded flops are cheap (the whole grid-20k factorization is
    ~0.4 GFLOP)."""
    if v <= 0:
        return 0
    b = lo
    while b < v:
        b *= 4 if b < 512 else 2
    return b


@dataclasses.dataclass
class _Bucket:
    """One (level, shape) group of supernodes, batched on device."""

    w_pad: int
    u_pad: int
    count: int
    cols_idx: np.ndarray     # (L, w_pad) gather/scatter idx into x; dummy = n
    below_idx: np.ndarray    # (L, u_pad) idx of below-diagonal rows; dummy = n
    asm_src: np.ndarray      # gather into a_values (A assembly)
    asm_dst: np.ndarray      # flat scatter into the (L*r_pad*r_pad,) fronts
    pad_dst: np.ndarray      # unit-diagonal positions for width padding
    child_src: np.ndarray    # gather into upd_buf (extend-add)
    child_dst: np.ndarray    # flat scatter into fronts
    upd_src: np.ndarray      # gather from the (L*u_pad*u_pad,) update tensor
    upd_dst: np.ndarray      # scatter (set) into upd_buf
    diag_rows: np.ndarray    # (L, w_pad) real-column mask


@dataclasses.dataclass
class _Chain:
    """A single-child assembly-tree path run as one lax.scan.

    Per-step stacked index arrays (first axis = chain position); the scan
    carry is the (u_pad, u_pad) padded Schur update handed to the next
    front.  `init_src` seeds the carry from a non-chain child's update in
    upd_buf (scratch slot = len(upd_buf) reads 0); `final_src/dst` write
    the last update out for the chain's parent.
    """

    w_pad: int
    u_pad: int
    count: int
    cols_idx: np.ndarray     # (K, w_pad) dummy = n
    below_idx: np.ndarray    # (K, u_pad) dummy = n
    asm_src: np.ndarray      # (K, La) into a_values (pad: src 0 -> scratch)
    asm_dst: np.ndarray      # (K, La) into flat front + scratch slot
    pad_dst: np.ndarray      # (K, Lp) unit-diagonal positions (scratch-padded)
    chain_dst: np.ndarray    # (K, Lt) carry tril pairs -> front (scratch-padded)
    tri_src: np.ndarray      # (Lt,) static tril gather from the (u_pad^2,) carry
    init_src: Optional[np.ndarray]   # (u_pad^2,) gather from upd_buf (+scratch)
    final_src: Optional[np.ndarray]  # gather from padded final carry
    final_dst: Optional[np.ndarray]  # scatter into upd_buf
    diag_rows: np.ndarray    # (K, w_pad) real-column mask


@dataclasses.dataclass
class _BucketScan:
    """K consecutive same-shape rounds run as ONE `lax.scan` (leading axis
    of every array = round index).  Cross-round dependencies flow through
    the scan carry (the flat `upd_buf` update array), so any topological
    sequence of same-shape rounds compiles to a single XLA stage regardless
    of K — the generalization of `_Chain` to multi-node rounds.  Lane count
    is padded to the largest round; padding slots factor identity fronts
    (unit diagonal injected via pad_dst) and scatter their update to the
    upd_buf scratch slot."""

    w_pad: int
    u_pad: int
    count: int               # padded lanes per step
    steps: int               # K
    cols_idx: np.ndarray     # (K, count, w_pad); dummy = n
    below_idx: np.ndarray    # (K, count, max(u_pad, 1)); dummy = n
    asm_src: np.ndarray      # (K, Ea) into a_values (pad: src 0)
    asm_dst: np.ndarray      # (K, Ea) into flat fronts (pad: scratch)
    pad_dst: np.ndarray      # (K, Ep) unit-diagonal positions
    child_src: np.ndarray    # (K, Ec) gather from upd_buf (pad: 0)
    child_dst: np.ndarray    # (K, Ec) scatter into fronts (pad: scratch)
    upd_src: np.ndarray      # (K, Eu) gather from the update tensor
    upd_dst: np.ndarray      # (K, Eu) scatter into upd_buf (pad: scratch)
    diag_rows: np.ndarray    # (K, count, w_pad) real-column mask


@dataclasses.dataclass
class BucketedSymbolic:
    n: int
    perm: np.ndarray
    iperm: np.ndarray
    Up: np.ndarray
    Ui: np.ndarray
    schedule: List[object]    # topologically ordered _Bucket / _Chain items
    total_upd: int

    def permute_values(self, A: sp.spmatrix) -> np.ndarray:
        """Upper-triangle value array of P A P' in THIS schedule's CSC
        order.  Always use this (not a separate analyze()) — order='auto'
        may pick a different permutation per call."""
        Ap = sp.csc_matrix(A)[self.perm][:, self.perm]
        U = sp.triu(Ap.tocsr(), k=0, format="csc").sorted_indices()
        return np.asarray(U.data, dtype=np.float64)


# Pytree registrations: the schedule's gather/scatter index arrays are
# LEAVES so a device-resident twin (jax.device_put(bs)) can be passed as a
# jit ARGUMENT.  Baking them as host constants folds tens of MB into every
# lowered module — measured on the grid-20k normal matrix: 84 MB module,
# 8.4 s lower + 15.9 s XLA compile for ONE factorization walk (CPU), vs
# ~0 s with the arrays passed as arguments.  Shape/pad metadata stays
# static aux data.

def _register_sched(cls, leaf_fields, aux_fields):
    def flatten(obj):
        return ([getattr(obj, f) for f in leaf_fields],
                tuple(getattr(obj, f) for f in aux_fields))

    def unflatten(aux, children):
        return cls(**dict(zip(aux_fields, aux)),
                   **dict(zip(leaf_fields, children)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)


_register_sched(
    _Bucket,
    ("cols_idx", "below_idx", "asm_src", "asm_dst", "pad_dst",
     "child_src", "child_dst", "upd_src", "upd_dst", "diag_rows"),
    ("w_pad", "u_pad", "count"),
)
_register_sched(
    _Chain,
    ("cols_idx", "below_idx", "asm_src", "asm_dst", "pad_dst", "chain_dst",
     "tri_src", "init_src", "final_src", "final_dst", "diag_rows"),
    ("w_pad", "u_pad", "count"),
)
_register_sched(
    _BucketScan,
    ("cols_idx", "below_idx", "asm_src", "asm_dst", "pad_dst",
     "child_src", "child_dst", "upd_src", "upd_dst", "diag_rows"),
    ("w_pad", "u_pad", "count", "steps"),
)
_register_sched(
    BucketedSymbolic,
    ("perm", "iperm", "Up", "Ui", "schedule"),
    ("n", "total_upd"),
)


_CHAIN_MIN = 4  # minimum path length worth a scan


def schedule_cost(bs: "BucketedSymbolic",
                  stage_s: float = 30e-6,
                  flops_per_s: float = 5e12) -> float:
    """Predicted device seconds for one factorization of this schedule.

    Two terms: sequential dispatch latency (every bucket is one stage;
    every chain element is one lax.scan step) and padded-front flops.
    The constants are deliberately coarse — the model only has to rank
    orderings (see analyze_batched order='auto'), not predict wall time.
    """
    cost = 0.0
    for it in bs.schedule:
        w, u = it.w_pad, it.u_pad
        if isinstance(it, _Chain):
            lanes, steps = 1, it.count
        else:
            lanes, steps = it.count, getattr(it, "steps", 1)
        fl = lanes * steps * (w ** 3 / 3 + w * w * u + w * u * u)
        cost += steps * stage_s + fl / flops_per_s
    return cost


def _greedy_rounds(snodes, w_pads, u_pads):
    """Greedy availability scheduling: repeatedly emit, as ONE round, every
    READY supernode of the shape class with the most ready members (ready =
    all children already emitted).  Simultaneously-ready nodes are mutually
    independent by construction, so each round is a valid batch; the round
    sequence is a topological order of the assembly tree.  Ties prefer the
    previous round's shape so consecutive rounds scan-group."""
    from collections import defaultdict

    nsn = len(snodes)
    left = [len(sn.child_ids) for sn in snodes]
    ready = defaultdict(list)
    for s in range(nsn):
        if not snodes[s].child_ids:
            ready[(int(w_pads[s]), int(u_pads[s]))].append(s)
    rounds = []
    last = None
    done = 0
    while done < nsn:
        # Continue the last shape while it has ready members — consecutive
        # same-shape rounds compile as ONE scan stage, and compile time is
        # the cost being minimized (a short round only adds a ~µs scan
        # step).  Otherwise start the largest ready batch.
        if last in ready:
            key = last
        else:
            key = max(ready, key=lambda k: (len(ready[k]), k))
        ids = sorted(ready.pop(key))
        rounds.append((key, ids))
        done += len(ids)
        for s in ids:
            p = snodes[s].parent
            if p >= 0:
                left[p] -= 1
                if left[p] == 0:
                    ready[(int(w_pads[p]), int(u_pads[p]))].append(p)
        last = key
    return rounds


def _stack_buckets(buckets: List[_Bucket], n: int,
                   total_upd: int) -> _BucketScan:
    """Stack K same-shape rounds into one _BucketScan: lane count padded to
    the largest round (padding slots factor identity fronts and write their
    update to the upd_buf scratch slot = total_upd), per-round index arrays
    padded to the longest round's lengths (gather pads read slot 0, scatter
    pads write the respective scratch slot)."""
    w_pad, u_pad = buckets[0].w_pad, buckets[0].u_pad
    r_pad = w_pad + u_pad
    K = len(buckets)
    L = max(b.count for b in buckets)
    scratch_f = L * r_pad * r_pad

    def pad_rows(arrs, fill, width):
        out = np.full((K, L, width), fill, arrs[0].dtype)
        for k, a in enumerate(arrs):
            out[k, : a.shape[0], : a.shape[1]] = a
        return out

    def pad_flat(arrs, fill):
        E = max(a.size for a in arrs) if arrs else 0
        out = np.full((K, E), fill, np.int64)
        for k, a in enumerate(arrs):
            out[k, : a.size] = a
        return out

    # Width padding + identity diagonals for the padding lanes of short
    # rounds (a zero front would put 0 pivots into the factorization).
    pad_dsts = []
    for b in buckets:
        extra = [k * r_pad * r_pad + i * r_pad + i
                 for k in range(b.count, L) for i in range(w_pad)]
        pad_dsts.append(np.concatenate(
            [b.pad_dst, np.asarray(extra, np.int64)]))

    return _BucketScan(
        w_pad=w_pad, u_pad=u_pad, count=L, steps=K,
        cols_idx=pad_rows([b.cols_idx for b in buckets], n, w_pad),
        below_idx=pad_rows([b.below_idx for b in buckets], n,
                           max(u_pad, 1)),
        asm_src=pad_flat([b.asm_src for b in buckets], 0),
        asm_dst=pad_flat([b.asm_dst for b in buckets], scratch_f),
        pad_dst=pad_flat(pad_dsts, scratch_f),
        child_src=pad_flat([b.child_src for b in buckets], 0),
        child_dst=pad_flat([b.child_dst for b in buckets], scratch_f),
        upd_src=pad_flat([b.upd_src for b in buckets], 0),
        upd_dst=pad_flat([b.upd_dst for b in buckets], total_upd),
        diag_rows=pad_rows([b.diag_rows for b in buckets], False, w_pad),
    )


def _group_scans(run, n: int, total_upd: int) -> List[object]:
    """Collapse maximal consecutive same-shape runs of `(key, _Bucket)`
    into _BucketScan items (single rounds stay plain _Bucket)."""
    schedule: List[object] = []
    i = 0
    while i < len(run):
        j = i
        while j + 1 < len(run) and run[j + 1][0] == run[i][0]:
            j += 1
        if j == i:
            schedule.append(run[i][1])
        else:
            schedule.append(_stack_buckets([b for _, b in run[i: j + 1]],
                                           n, total_upd))
        i = j + 1
    return schedule


def analyze_batched(A: sp.spmatrix, order: str = "auto",
                    max_supernode: int = 128,
                    relax: int = 16,
                    schedule_mode: str = "greedy") -> BucketedSymbolic:
    """Host symbolic analysis producing the bucket/chain/scan schedule.

    schedule_mode:
      * "greedy" (default) — coarse shape classes (`_pad_class`) plus
        greedy availability scheduling: each round batches EVERY ready
        supernode of the most numerous shape (ready = all children
        emitted; simultaneously-ready nodes are independent, so a round is
        one batched dense-front stage), and consecutive same-shape rounds
        collapse into one `_BucketScan` `lax.scan` stage.  XLA program
        size scales with the number of shape runs (typically ≤ 10), not
        with supernodes or tree levels — this is what holds the sparse
        cold-compile tax down.
      * "level" — the round-2 scheduler: power-of-two pads, per-level
        shape buckets, single-child paths extracted as `_Chain` scans.
        Kept as the reference implementation for A/B tests.

    order='auto' builds the schedule under both AMD (minimum fill) and
    nested dissection (minimum critical path) and keeps the one with the
    lower predicted device cost: on an accelerator, sequential stage count
    is usually worth more than fill — the opposite of the CPU trade-off
    the reference's CHOLMOD default makes (src/utils.jl:60-62).
    """
    if order == "auto":
        cands = []
        err = None
        for o in ("amd", "nd"):
            try:
                cands.append(analyze_batched(
                    A, order=o, max_supernode=max_supernode,
                    relax=relax, schedule_mode=schedule_mode))
            except ScheduleTooLargeError as e:
                err = e  # one ordering may still fit the cap
        if not cands:
            raise err
        return min(cands, key=schedule_cost)
    symb = analyze(A, order=order, max_supernode=max_supernode, relax=relax)
    snodes = symb.supernodes
    nsn = len(snodes)
    n = symb.n

    u_sizes = np.asarray([sn.rows.size - sn.cols.size for sn in snodes])
    w_sizes = np.asarray([sn.cols.size for sn in snodes])
    if schedule_mode == "greedy":
        w_pads = np.asarray([_pad_class(int(w)) for w in w_sizes])
        u_pads = np.asarray([_pad_class(int(u)) if u else 0
                             for u in u_sizes])
    else:
        w_pads = np.asarray([_pad_pow2(int(w)) for w in w_sizes])
        u_pads = np.asarray([_pad_pow2(int(u)) if u else 0 for u in u_sizes])

    rounds = None
    if schedule_mode == "greedy":
        rounds = _greedy_rounds(snodes, w_pads, u_pads)
        # Tail merge: the top of the assembly tree dissolves into many
        # small rounds of assorted shapes (one XLA stage each).  Promote
        # every node in the maximal suffix of small rounds to the suffix's
        # max shape so the whole tail becomes consecutive same-shape
        # rounds == ONE scan stage; the extra padded flops are negligible
        # against the leaf rounds.
        cut = len(rounds)
        while cut > 1 and len(rounds[cut - 1][1]) <= 8:
            cut -= 1
        if len(rounds) - cut >= 2:
            tail = rounds[cut:]
            w_t = max(k[0] for k, _ in tail)
            u_t = max(k[1] for k, _ in tail)
            for _, ids in tail:
                for s in ids:
                    w_pads[s] = w_t
                    u_pads[s] = u_t
            rounds = rounds[:cut] + [((w_t, u_t), ids) for _, ids in tail]

    upd_off = np.zeros(nsn + 1, np.int64)
    np.cumsum(u_sizes * u_sizes, out=upd_off[1:])
    total_upd = int(upd_off[-1])
    # Feasibility guard: the flat scatter-map numeric phase
    # materializes index arrays proportional to the PADDED update
    # traffic.  High-fill patterns (laplqp's 22.5k grid Laplacian ND
    # factorization) explode this to billions of entries — the symbolic
    # phase alone ate >55 GB of host memory.  The default cap was sized
    # for a 16 GB device and awaits a re-derivation.  Fail fast with a typed error so
    # drivers can fall back to the host path cleanly.
    padded_upd = int(np.sum((u_pads.astype(np.int64)) ** 2))
    cap = int(float(__import__("os").environ.get(
        "MADQP_MAX_UPDATE_ENTRIES", 2.5e8)))
    if total_upd > cap or padded_upd > cap:
        raise ScheduleTooLargeError(
            f"supernodal schedule update traffic "
            f"(total {total_upd:.2e}, padded {padded_upd:.2e} entries) "
            f"exceeds MADQP_MAX_UPDATE_ENTRIES={cap:.2e}; this fill "
            "pattern needs a hierarchical multifrontal numeric phase "
            "(use the host path)")
    scratch_buf = total_upd  # read-as-zero / write-scratch slot

    # ---- chain extraction: maximal single-child constant-shape paths ----
    # (level mode only; the greedy mode's _BucketScan subsumes chains.)
    in_chain = np.zeros(nsn, bool)
    chains: List[List[int]] = []
    if schedule_mode != "greedy":
        for s in range(nsn):
            if in_chain[s] or u_pads[s] == 0:
                continue
            ch = snodes[s].child_ids
            if len(ch) > 1:
                continue  # multi-child assembly cannot live in a scan step
            # Skip s when its single child will extend a chain INTO s (s is
            # a tail element of a chain headed further down).
            if len(ch) == 1 and not in_chain[ch[0]] \
                    and len(snodes[ch[0]].child_ids) <= 1 \
                    and (w_pads[ch[0]], u_pads[ch[0]]) == (w_pads[s],
                                                           u_pads[s]) \
                    and u_pads[ch[0]] > 0:
                continue
            seq = [s]
            cur = s
            while True:
                p = snodes[cur].parent
                if p < 0 or snodes[p].child_ids != [cur]:
                    break
                if (w_pads[p], u_pads[p]) != (w_pads[s], u_pads[s]):
                    break
                if u_pads[p] == 0:
                    break
                seq.append(p)
                cur = p
            if len(seq) >= _CHAIN_MIN:
                for t in seq:
                    in_chain[t] = True
                chains.append(seq)

    # ---- helper: local-position map respecting padded update offset ----
    def loc_of(t):
        w = int(w_sizes[t])
        wp = int(w_pads[t])
        return {
            int(g): (k if k < w else wp + (k - w))
            for k, g in enumerate(snodes[t].rows)
        }

    # A-assembly entries per supernode, in padded-front coordinates.
    Up, Ui = symb.Up, symb.Ui
    col_sn = np.empty(n, np.int32)
    for sid, sn in enumerate(snodes):
        col_sn[sn.cols[0]: sn.cols[-1] + 1] = sid
    asm_by_sn: List[List[tuple]] = [[] for _ in range(nsn)]
    locmaps = [loc_of(t) for t in range(nsn)]
    for j in range(n):
        for p in range(Up[j], Up[j + 1]):
            i = int(Ui[p])  # i <= j
            sid = int(col_sn[i])
            loc = locmaps[sid]
            a, b = loc[j], loc[i]
            if a < b:
                a, b = b, a
            asm_by_sn[sid].append((p, a, b))

    schedule: List[object] = []

    def make_bucket(ids, w_pad, u_pad) -> _Bucket:
        r_pad = w_pad + u_pad
        L = len(ids)
        cols_idx = np.full((L, w_pad), n, np.int32)
        below_idx = np.full((L, max(u_pad, 1)), n, np.int32)
        diag_rows = np.zeros((L, w_pad), bool)
        asm_src, asm_dst, pad_dst = [], [], []
        child_src, child_dst = [], []
        upd_src, upd_dst = [], []
        for k, s in enumerate(ids):
            sn = snodes[s]
            w, u = int(w_sizes[s]), int(u_sizes[s])
            cols_idx[k, :w] = sn.cols
            if u:
                below_idx[k, :u] = sn.rows[w:]
            diag_rows[k, :w] = True
            base = k * r_pad * r_pad
            for p, a, b in asm_by_sn[s]:
                asm_src.append(p)
                asm_dst.append(base + a * r_pad + b)
            for i in range(w, w_pad):
                pad_dst.append(base + i * r_pad + i)
            lmap = locmaps[s]
            for c in sn.child_ids:
                chs = snodes[c]
                urows = chs.rows[chs.cols.size:]
                uc = urows.size
                lidx = np.asarray([lmap[int(g)] for g in urows])
                off = upd_off[c]
                for ci in range(uc):
                    for cj in range(ci + 1):
                        a2, b2 = lidx[ci], lidx[cj]
                        if a2 < b2:
                            a2, b2 = b2, a2
                        child_src.append(off + ci * uc + cj)
                        child_dst.append(base + a2 * r_pad + b2)
            ubase = k * u_pad * u_pad
            off = upd_off[s]
            for ci in range(u):
                for cj in range(u):
                    upd_src.append(ubase + ci * u_pad + cj)
                    upd_dst.append(off + ci * u + cj)
        return _Bucket(
            w_pad=w_pad, u_pad=u_pad, count=L,
            cols_idx=cols_idx, below_idx=below_idx,
            asm_src=np.asarray(asm_src, np.int64),
            asm_dst=np.asarray(asm_dst, np.int64),
            pad_dst=np.asarray(pad_dst, np.int64),
            child_src=np.asarray(child_src, np.int64),
            child_dst=np.asarray(child_dst, np.int64),
            upd_src=np.asarray(upd_src, np.int64),
            upd_dst=np.asarray(upd_dst, np.int64),
            diag_rows=diag_rows,
        )

    if schedule_mode == "greedy":
        run = [(key, make_bucket(ids, *key)) for key, ids in rounds]
        schedule = _group_scans(run, n, total_upd)
        return BucketedSymbolic(
            n=n, perm=symb.perm, iperm=symb.iperm, Up=symb.Up, Ui=symb.Ui,
            schedule=schedule, total_upd=total_upd,
        )

    # ---- level mode: regular buckets per level over non-chain nodes ----
    # Tree levels: leaves at 0, parent strictly above all children.
    level = np.zeros(nsn, np.int64)
    for s in range(nsn):  # postorder: children come first
        p = snodes[s].parent
        if p >= 0:
            level[p] = max(level[p], level[s] + 1)
    nlev = int(level.max()) + 1 if nsn else 0
    bucket_items = {}
    for lev in range(nlev):
        members = [s for s in range(nsn)
                   if level[s] == lev and not in_chain[s]]
        groups: dict = {}
        for s in members:
            groups.setdefault((int(w_pads[s]), int(u_pads[s])), []).append(s)
        for (w_pad, u_pad), ids in sorted(groups.items()):
            bucket_items.setdefault(lev, []).append(
                make_bucket(ids, w_pad, u_pad))

    # ---- chain records ----
    chain_items = []
    for seq in chains:
        s0 = seq[0]
        w_pad, u_pad = int(w_pads[s0]), int(u_pads[s0])
        r_pad = w_pad + u_pad
        scratch_f = r_pad * r_pad
        K = len(seq)
        tri_pairs = [(ci, cj) for ci in range(u_pad) for cj in range(ci + 1)]
        tri_src = np.asarray([ci * u_pad + cj for ci, cj in tri_pairs],
                             np.int64)
        La = max(len(asm_by_sn[s]) for s in seq)
        Lp = max(int(w_pads[s]) - int(w_sizes[s]) for s in seq)
        asm_src = np.zeros((K, max(La, 1)), np.int64)
        asm_dst = np.full((K, max(La, 1)), scratch_f, np.int64)
        pad_dst = np.full((K, max(Lp, 1)), scratch_f, np.int64)
        chain_dst = np.full((K, max(len(tri_pairs), 1)), scratch_f, np.int64)
        cols_idx = np.full((K, w_pad), n, np.int32)
        below_idx = np.full((K, max(u_pad, 1)), n, np.int32)
        diag_rows = np.zeros((K, w_pad), bool)
        for k, s in enumerate(seq):
            sn = snodes[s]
            w, u = int(w_sizes[s]), int(u_sizes[s])
            cols_idx[k, :w] = sn.cols
            below_idx[k, :u] = sn.rows[w:]
            diag_rows[k, :w] = True
            for e, (p, a, b) in enumerate(asm_by_sn[s]):
                asm_src[k, e] = p
                asm_dst[k, e] = a * r_pad + b
            for e, i in enumerate(range(w, w_pad)):
                pad_dst[k, e] = i * r_pad + i
            # carry extend-add: predecessor's update rows -> this front
            pred = seq[k - 1] if k else (sn.child_ids[0] if sn.child_ids
                                         else None)
            if pred is not None:
                urows = snodes[pred].rows[snodes[pred].cols.size:]
                u_prev = urows.size
                lmap = locmaps[s]
                lidx = np.asarray([lmap[int(g)] for g in urows])
                for e, (ci, cj) in enumerate(tri_pairs):
                    if ci < u_prev and cj < u_prev:
                        a2, b2 = lidx[ci], lidx[cj]
                        if a2 < b2:
                            a2, b2 = b2, a2
                        chain_dst[k, e] = a2 * r_pad + b2
        # init carry from the head's (single, non-chain) child, if any
        head_children = snodes[s0].child_ids
        assert len(head_children) <= 1
        init_src = None
        if head_children:
            c0 = head_children[0]
            u0 = int(u_sizes[c0])
            assert u0 <= u_pad, "chain head child update exceeds carry pad"
            init_src = np.full(u_pad * u_pad, scratch_buf, np.int64)
            for ci in range(u0):
                for cj in range(u0):
                    init_src[ci * u_pad + cj] = upd_off[c0] + ci * u0 + cj
        # final update write-out, if the chain's root has a parent
        s_last = seq[-1]
        final_src = final_dst = None
        if snodes[s_last].parent >= 0:
            uK = int(u_sizes[s_last])
            final_src = np.asarray(
                [ci * u_pad + cj for ci in range(uK) for cj in range(uK)],
                np.int64)
            final_dst = upd_off[s_last] + np.arange(uK * uK, dtype=np.int64)
        chain_items.append((int(level[s0]), _Chain(
            w_pad=w_pad, u_pad=u_pad, count=K,
            cols_idx=cols_idx, below_idx=below_idx,
            asm_src=asm_src, asm_dst=asm_dst, pad_dst=pad_dst,
            chain_dst=chain_dst, tri_src=tri_src,
            init_src=init_src, final_src=final_src, final_dst=final_dst,
            diag_rows=diag_rows,
        )))

    # ---- schedule: ascending by level of first element ----
    for lev in range(nlev):
        schedule.extend(bucket_items.get(lev, []))
        for lv, ch in chain_items:
            if lv == lev:
                schedule.append(ch)

    return BucketedSymbolic(
        n=n, perm=symb.perm, iperm=symb.iperm, Up=symb.Up, Ui=symb.Ui,
        schedule=schedule, total_upd=total_upd,
    )


def _assemble_bucket(bk: _Bucket, a_values, upd_buf, dtype):
    Lb, w_pad, u_pad = bk.count, bk.w_pad, bk.u_pad
    r_pad = w_pad + u_pad
    F = jnp.zeros((Lb * r_pad * r_pad,), dtype)
    F = F.at[bk.asm_dst].add(a_values[bk.asm_src].astype(dtype))
    if bk.pad_dst.size:
        F = F.at[bk.pad_dst].add(jnp.ones((bk.pad_dst.size,), dtype))
    if bk.child_src.size:
        F = F.at[bk.child_dst].add(upd_buf[bk.child_src])
    F = F.reshape(Lb, r_pad, r_pad)
    return jnp.tril(F) + jnp.tril(F, -1).transpose(0, 2, 1)


def _chain_scan(ch: _Chain, a_values, upd_buf, dtype, ldl: bool,
                sgn=None, pivot_floor: float = 0.0,
                inverse: bool = False):
    """Run one chain as a lax.scan; returns (panels, d or None, upd_buf)."""
    w_pad, u_pad = ch.w_pad, ch.u_pad
    r_pad = w_pad + u_pad
    if ch.init_src is not None:
        buf_ext = jnp.concatenate([upd_buf, jnp.zeros((1,), dtype)])
        U0 = buf_ext[ch.init_src].reshape(u_pad, u_pad)
    else:
        U0 = jnp.zeros((u_pad, u_pad), dtype)

    def step(U_prev, xs):
        a_s, a_d, p_d, c_d, sg = xs
        F = jnp.zeros((r_pad * r_pad + 1,), dtype)
        F = F.at[a_d].add(a_values[a_s].astype(dtype))
        F = F.at[p_d].add(jnp.ones(p_d.shape, dtype))
        F = F.at[c_d].add(U_prev.reshape(-1)[ch.tri_src])
        F = F[:-1].reshape(r_pad, r_pad)
        F = jnp.tril(F) + jnp.tril(F, -1).T
        # GEMM-rich blocked factorization + explicit diagonal-block inverse
        # (ops/blocked_dense) in place of XLA's cholesky/triangular_solve
        # sequential column sweeps.
        if ldl:
            L11, d = blocked_ldl(F[:w_pad, :w_pad], sgn=sg, floor=pivot_floor)
            i11 = inv_unit_lower(L11)
            Z = F[w_pad:, :w_pad] @ i11.T          # Z = F21 L11^{-T}
            L21 = Z / d[None, :]
            U = F[w_pad:, w_pad:] - Z @ L21.T
            top = i11 if inverse else L11
            return U, (jnp.concatenate([top, L21], axis=0), d)
        Lu, d = blocked_ldl(F[:w_pad, :w_pad])
        sq = jnp.sqrt(d)
        L11 = Lu * sq[None, :]                     # Cholesky factor L = Lu√d
        i11 = inv_unit_lower(Lu) / sq[:, None]     # inv(L) = D^-1/2 inv(Lu)
        L21 = F[w_pad:, :w_pad] @ i11.T
        U = F[w_pad:, w_pad:] - L21 @ L21.T
        top = i11 if inverse else L11
        return U, (jnp.concatenate([top, L21], axis=0), None)

    sgn_rows = (jnp.asarray(sgn, dtype) if sgn is not None
                else jnp.ones((ch.count, w_pad), dtype))
    xs = (ch.asm_src, ch.asm_dst, ch.pad_dst, ch.chain_dst, sgn_rows)
    Ufin, (panels, dvec) = jax.lax.scan(step, U0, xs)
    if ch.final_dst is not None:
        upd_buf = upd_buf.at[ch.final_dst].set(
            Ufin.reshape(-1)[ch.final_src])
    return panels, dvec, upd_buf


def _chain_solve_fwd(ch: _Chain, panels, x, n, unit=False, inverse=False):
    w_pad = ch.w_pad

    def fstep(x, xs):
        ci, bi, P = xs
        if inverse:
            xj = P[:w_pad, :] @ x[ci]
        else:
            xj = jsl.solve_triangular(P[:w_pad, :], x[ci], lower=True,
                                      unit_diagonal=unit)
        x = x.at[ci].set(xj)
        x = x.at[bi].add(-(P[w_pad:, :] @ xj))
        x = x.at[n].set(0.0)
        return x, None

    x, _ = jax.lax.scan(fstep, x, (ch.cols_idx, ch.below_idx, panels))
    return x


def _chain_solve_bwd(ch: _Chain, panels, x, n, unit=False, inverse=False):
    w_pad = ch.w_pad

    def bstep(x, xs):
        ci, bi, P = xs
        rhs = x[ci] - P[w_pad:, :].T @ x[bi]
        if inverse:
            xj = P[:w_pad, :].T @ rhs
        else:
            xj = jsl.solve_triangular(P[:w_pad, :].T, rhs, lower=False,
                                      unit_diagonal=unit)
        x = x.at[ci].set(xj)
        x = x.at[n].set(0.0)
        return x, None

    x, _ = jax.lax.scan(bstep, x, (ch.cols_idx, ch.below_idx, panels),
                        reverse=True)
    return x


def _inv_lower(L, unit: bool = False):
    """Batched explicit inverse of lower-triangular L (small panel widths;
    turns the latency-bound per-front triangular backsolves into
    matmuls — same trade as the dense path's solve_mode='inverse').
    GEMM-rich blocked recursion (ops/blocked_dense) in place of XLA's
    triangular_solve-against-identity."""
    from .blocked_dense import inv_lower as _blk_inv
    return _blk_inv(L, unit=unit)


def _scanbucket_factorize(sb: _BucketScan, a_values, upd_buf, dtype,
                          ldl: bool = False, sgn=None,
                          pivot_floor: float = 0.0, inverse: bool = False):
    """Run K same-shape rounds as one lax.scan over the stacked index
    arrays; the carry is the flat upd_buf (scratch slot = total_upd).
    Returns (panels (K, L, r_pad, w_pad), dvec (K, L, w_pad), upd_buf)."""
    w_pad, u_pad, L = sb.w_pad, sb.u_pad, sb.count
    r_pad = w_pad + u_pad
    nfront = L * r_pad * r_pad
    use_floor = ldl and sgn is not None and pivot_floor > 0.0
    sgn_steps = (jnp.asarray(sgn, dtype) if use_floor
                 else jnp.ones((sb.steps, L, w_pad), dtype))

    def step(upd_buf, xs):
        a_s, a_d, p_d, c_s, c_d, u_s, u_d, sg = xs
        F = jnp.zeros((nfront + 1,), dtype)
        F = F.at[a_d].add(a_values[a_s].astype(dtype))
        F = F.at[p_d].add(jnp.ones(p_d.shape, dtype))
        if c_s.shape[0]:
            F = F.at[c_d].add(upd_buf[c_s])
        F = F[:-1].reshape(L, r_pad, r_pad)
        F = jnp.tril(F) + jnp.tril(F, -1).transpose(0, 2, 1)
        # Blocked GEMM-rich factorization + explicit diagonal-block inverse
        # (ops/blocked_dense) — same kernels as the _Bucket path.
        if ldl:
            L11, d = blocked_ldl(F[:, :w_pad, :w_pad],
                                 sgn=sg if use_floor else None,
                                 floor=pivot_floor)
            i11 = inv_unit_lower(L11)
            top = i11 if inverse else L11
            if u_pad:
                Z = F[:, w_pad:, :w_pad] @ i11.transpose(0, 2, 1)
                L21 = Z / d[:, None, :]
                U = F[:, w_pad:, w_pad:] - Z @ L21.transpose(0, 2, 1)
        else:
            Lu, d = blocked_ldl(F[:, :w_pad, :w_pad])
            sq = jnp.sqrt(d)
            L11 = Lu * sq[:, None, :]
            i11 = inv_unit_lower(Lu) / sq[:, :, None]
            top = i11 if inverse else L11
            if u_pad:
                L21 = F[:, w_pad:, :w_pad] @ i11.transpose(0, 2, 1)
                U = F[:, w_pad:, w_pad:] - L21 @ L21.transpose(0, 2, 1)
        if u_pad:
            panel = jnp.concatenate([top, L21], axis=1)
            if u_s.shape[0]:
                upd_buf = upd_buf.at[u_d].set(U.reshape(-1)[u_s])
        else:
            panel = top
        return upd_buf, (panel, d)

    xs = (sb.asm_src, sb.asm_dst, sb.pad_dst, sb.child_src, sb.child_dst,
          sb.upd_src, sb.upd_dst, sgn_steps)
    upd_buf, (panels, dvec) = jax.lax.scan(step, upd_buf, xs)
    return panels, dvec, upd_buf


def _scanbucket_solve_fwd(sb: _BucketScan, panels, x, n, unit=False,
                          inverse=False):
    w_pad, u_pad = sb.w_pad, sb.u_pad

    def fstep(x, xs):
        ci, bi, P = xs
        if inverse:
            xj = (P[:, :w_pad, :] @ x[ci][..., None])[..., 0]
        else:
            xj = jax.lax.linalg.triangular_solve(
                P[:, :w_pad, :], x[ci][..., None], left_side=True,
                lower=True, unit_diagonal=unit)[..., 0]
        x = x.at[ci.reshape(-1)].set(xj.reshape(-1))
        if u_pad:
            y = (P[:, w_pad:, :] @ xj[..., None])[..., 0]
            x = x.at[bi.reshape(-1)].add(-y.reshape(-1))
        x = x.at[n].set(0.0)
        return x, None

    x, _ = jax.lax.scan(fstep, x, (sb.cols_idx, sb.below_idx, panels))
    return x


def _scanbucket_solve_bwd(sb: _BucketScan, panels, x, n, unit=False,
                          inverse=False):
    w_pad, u_pad = sb.w_pad, sb.u_pad

    def bstep(x, xs):
        ci, bi, P = xs
        rhs = x[ci]
        if u_pad:
            rhs = rhs - (P[:, w_pad:, :].transpose(0, 2, 1)
                         @ x[bi][..., None])[..., 0]
        if inverse:
            xj = (P[:, :w_pad, :].transpose(0, 2, 1)
                  @ rhs[..., None])[..., 0]
        else:
            xj = jax.lax.linalg.triangular_solve(
                P[:, :w_pad, :], rhs[..., None], left_side=True, lower=True,
                transpose_a=True, unit_diagonal=unit)[..., 0]
        x = x.at[ci.reshape(-1)].set(xj.reshape(-1))
        x = x.at[n].set(0.0)
        return x, None

    x, _ = jax.lax.scan(bstep, x, (sb.cols_idx, sb.below_idx, panels),
                        reverse=True)
    return x


def factorize_batched(bs: BucketedSymbolic, a_values, inverse: bool = False):
    """Batched numeric Cholesky over the schedule.  Returns panels: one
    array per schedule item — (L, r_pad, w_pad) for buckets, (K, r_pad,
    w_pad) for chains (a flat pytree list).  With inverse=True the stored
    diagonal block is inv(L11) and solves become matmuls."""
    dtype = a_values.dtype
    upd_buf = jnp.zeros((bs.total_upd + 1,), dtype)  # last slot = scratch
    panels = []
    for item in bs.schedule:
        if isinstance(item, _BucketScan):
            P, _, upd_buf = _scanbucket_factorize(item, a_values, upd_buf,
                                                  dtype, inverse=inverse)
            panels.append(P)
            continue
        if isinstance(item, _Chain):
            P, _, upd_buf = _chain_scan(item, a_values, upd_buf, dtype,
                                        ldl=False, inverse=inverse)
            panels.append(P)
            continue
        bk = item
        w_pad, u_pad = bk.w_pad, bk.u_pad
        F = _assemble_bucket(bk, a_values, upd_buf, dtype)
        # Blocked GEMM-rich Cholesky + explicit inverse replace XLA's
        # cholesky/triangular_solve; the trsm becomes a matmul.
        Lu, dch = blocked_ldl(F[:, :w_pad, :w_pad])
        sq = jnp.sqrt(dch)
        L11 = Lu * sq[:, None, :]
        i11 = inv_unit_lower(Lu) / sq[:, :, None]
        top = i11 if inverse else L11
        if u_pad:
            L21 = F[:, w_pad:, :w_pad] @ i11.transpose(0, 2, 1)
            U = F[:, w_pad:, w_pad:] - L21 @ L21.transpose(0, 2, 1)
            panels.append(jnp.concatenate([top, L21], axis=1))
            if bk.upd_dst.size:
                upd_buf = upd_buf.at[bk.upd_dst].set(
                    U.reshape(-1)[bk.upd_src])
        else:
            panels.append(top)
    return panels


def solve_batched(bs: BucketedSymbolic, panels, b, inverse: bool = False):
    """Level-scheduled batched triangular solves: L y = b, then L' x = y.
    With inverse=True (matching factorize_batched) the diagonal blocks are
    already inverted and every sweep step is a matmul."""
    x = jnp.concatenate([jnp.asarray(b)[bs.perm], jnp.zeros((1,), b.dtype)])
    n = bs.n
    # forward
    for item, P in zip(bs.schedule, panels):
        if isinstance(item, _BucketScan):
            x = _scanbucket_solve_fwd(item, P, x, n, inverse=inverse)
            continue
        if isinstance(item, _Chain):
            x = _chain_solve_fwd(item, P, x, n, inverse=inverse)
            continue
        bk = item
        w_pad, u_pad = bk.w_pad, bk.u_pad
        if inverse:
            xj = (P[:, :w_pad, :] @ x[bk.cols_idx][..., None])[..., 0]
        else:
            xj = jax.lax.linalg.triangular_solve(
                P[:, :w_pad, :], x[bk.cols_idx][..., None], left_side=True,
                lower=True,
            )[..., 0]
        x = x.at[bk.cols_idx.reshape(-1)].set(xj.reshape(-1))
        if u_pad:
            y = (P[:, w_pad:, :] @ xj[..., None])[..., 0]
            x = x.at[bk.below_idx.reshape(-1)].add(-y.reshape(-1))
        x = x.at[n].set(0.0)
    # backward
    for item, P in zip(bs.schedule[::-1], panels[::-1]):
        if isinstance(item, _BucketScan):
            x = _scanbucket_solve_bwd(item, P, x, n, inverse=inverse)
            continue
        if isinstance(item, _Chain):
            x = _chain_solve_bwd(item, P, x, n, inverse=inverse)
            continue
        bk = item
        w_pad, u_pad = bk.w_pad, bk.u_pad
        rhs = x[bk.cols_idx]
        if u_pad:
            xb = x[bk.below_idx]
            rhs = rhs - (P[:, w_pad:, :].transpose(0, 2, 1)
                         @ xb[..., None])[..., 0]
        if inverse:
            xj = (P[:, :w_pad, :].transpose(0, 2, 1)
                  @ rhs[..., None])[..., 0]
        else:
            xj = jax.lax.linalg.triangular_solve(
                P[:, :w_pad, :], rhs[..., None], left_side=True, lower=True,
                transpose_a=True,
            )[..., 0]
        x = x.at[bk.cols_idx.reshape(-1)].set(xj.reshape(-1))
        x = x.at[n].set(0.0)
    return x[:-1][bs.iperm]


def factor_ok_batched(panels) -> jax.Array:
    """All diagonal pivots finite and positive (padding diag is 1)."""
    ok = jnp.asarray(True)
    for P in panels:
        w = P.shape[-1]
        d = jnp.diagonal(P[..., :w, :], axis1=-2, axis2=-1)
        ok = ok & jnp.all(jnp.isfinite(d)) & jnp.all(d > 0)
    return ok


# ---------------------------------------------------------------------------
# Signed LDL^T numeric phase over the same schedule: factorizes symmetric
# QUASI-DEFINITE matrices (reference SURVEY §7.3 #1: "emulate
# [Bunch-Kaufman] via regularized quasi-definite LDL^T — signed diagonal,
# no pivoting").  This is what the augmented KKT [W A'; A dc I] needs: W
# block positive, dual block negative, both kept away from zero by the
# IPM's primal/dual regularization, so no dynamic pivoting is required
# (Vanderbei's quasi-definite factorization theorem — same justification
# as the reference's cuDSS pivotless LDL path).
# ---------------------------------------------------------------------------


def dense_ldl(F, sgn=None, floor: float = 0.0):
    """No-pivot LDL^T of (..., w, w) symmetric matrices: F = L D L' with L
    unit lower triangular.

    With `sgn` ((..., w) expected pivot signs) and `floor` > 0, pivots are
    perturbed to sgn * max(sgn * d, floor) — the cuDSS-style pivot
    perturbation that keeps a quasi-definite f32 factorization usable near
    convergence; iterative refinement absorbs the perturbation.

    Delegates to the GEMM-rich blocked implementation (ops/blocked_dense):
    only 32-wide base panels stay column-sequential."""
    return blocked_ldl(F, sgn=sgn, floor=floor)


def factorize_batched_ldl(bs: BucketedSymbolic, a_values, signs=None,
                          pivot_floor: float = 0.0,
                          inverse: bool = False):
    """Batched supernodal LDL^T over the schedule.  Returns (panels, dvecs,
    dglob): per-item unit-lower panels, pivot vectors, and the global pivot
    vector in permuted order (n+1, last slot dummy 1).

    `signs` (the bucket_signs list) + `pivot_floor` > 0 enable sign-directed
    pivot perturbation (see dense_ldl)."""
    dtype = a_values.dtype
    upd_buf = jnp.zeros((bs.total_upd + 1,), dtype)  # last slot = scratch
    dglob = jnp.ones((bs.n + 1,), dtype)
    panels, dvecs = [], []
    for i, item in enumerate(bs.schedule):
        sgn = None
        if signs is not None and pivot_floor > 0.0:
            sgn = np.asarray(signs[i], np.float64)
        if isinstance(item, _BucketScan):
            P, d, upd_buf = _scanbucket_factorize(
                item, a_values, upd_buf, dtype, ldl=True, sgn=sgn,
                pivot_floor=pivot_floor, inverse=inverse)
            panels.append(P)
            dvecs.append(d)
            dglob = dglob.at[item.cols_idx.reshape(-1)].set(d.reshape(-1))
            continue
        if isinstance(item, _Chain):
            P, d, upd_buf = _chain_scan(item, a_values, upd_buf, dtype,
                                        ldl=True, sgn=sgn,
                                        pivot_floor=pivot_floor,
                                        inverse=inverse)
            panels.append(P)
            dvecs.append(d)
            dglob = dglob.at[item.cols_idx.reshape(-1)].set(d.reshape(-1))
            continue
        bk = item
        w_pad, u_pad = bk.w_pad, bk.u_pad
        F = _assemble_bucket(bk, a_values, upd_buf, dtype)
        # Blocked GEMM-rich LDL + explicit unit inverse (ops/blocked_dense)
        # replace XLA-sequential dense_ldl column sweeps and trsm.
        L11, d = blocked_ldl(F[:, :w_pad, :w_pad],
                             sgn=None if sgn is None else jnp.asarray(sgn, dtype),
                             floor=pivot_floor)
        dglob = dglob.at[bk.cols_idx.reshape(-1)].set(d.reshape(-1))
        dvecs.append(d)
        i11 = inv_unit_lower(L11)
        top = i11 if inverse else L11
        if u_pad:
            # Z = F21 L11^{-T};  L21 = Z / d;  U = F22 - Z diag(1/d) Z'
            Z = F[:, w_pad:, :w_pad] @ i11.transpose(0, 2, 1)
            L21 = Z / d[:, None, :]
            U = F[:, w_pad:, w_pad:] - Z @ L21.transpose(0, 2, 1)
            panels.append(jnp.concatenate([top, L21], axis=1))
            if bk.upd_dst.size:
                upd_buf = upd_buf.at[bk.upd_dst].set(
                    U.reshape(-1)[bk.upd_src])
        else:
            panels.append(top)
    dglob = dglob.at[bs.n].set(1.0)
    return panels, dvecs, dglob


def solve_batched_ldl(bs: BucketedSymbolic, factors, b,
                      inverse: bool = False):
    """Solve A x = b given the supernodal LDL^T factors: L z = b (unit
    lower, level-scheduled), z /= d, L' x = z.  inverse=True must match
    the factorization (diagonal blocks stored as inv(L11))."""
    panels, _, dglob = factors
    x = jnp.concatenate([jnp.asarray(b)[bs.perm], jnp.zeros((1,), b.dtype)])
    n = bs.n
    for item, P in zip(bs.schedule, panels):
        if isinstance(item, _BucketScan):
            x = _scanbucket_solve_fwd(item, P, x, n, unit=True,
                                      inverse=inverse)
            continue
        if isinstance(item, _Chain):
            x = _chain_solve_fwd(item, P, x, n, unit=True, inverse=inverse)
            continue
        bk = item
        w_pad, u_pad = bk.w_pad, bk.u_pad
        if inverse:
            xj = (P[:, :w_pad, :] @ x[bk.cols_idx][..., None])[..., 0]
        else:
            xj = jax.lax.linalg.triangular_solve(
                P[:, :w_pad, :], x[bk.cols_idx][..., None], left_side=True,
                lower=True, unit_diagonal=True,
            )[..., 0]
        x = x.at[bk.cols_idx.reshape(-1)].set(xj.reshape(-1))
        if u_pad:
            y = (P[:, w_pad:, :] @ xj[..., None])[..., 0]
            x = x.at[bk.below_idx.reshape(-1)].add(-y.reshape(-1))
        x = x.at[n].set(0.0)
    x = x / dglob
    for item, P in zip(bs.schedule[::-1], panels[::-1]):
        if isinstance(item, _BucketScan):
            x = _scanbucket_solve_bwd(item, P, x, n, unit=True,
                                      inverse=inverse)
            continue
        if isinstance(item, _Chain):
            x = _chain_solve_bwd(item, P, x, n, unit=True, inverse=inverse)
            continue
        bk = item
        w_pad, u_pad = bk.w_pad, bk.u_pad
        rhs = x[bk.cols_idx]
        if u_pad:
            xb = x[bk.below_idx]
            rhs = rhs - (P[:, w_pad:, :].transpose(0, 2, 1)
                         @ xb[..., None])[..., 0]
        if inverse:
            xj = (P[:, :w_pad, :].transpose(0, 2, 1)
                  @ rhs[..., None])[..., 0]
        else:
            xj = jax.lax.linalg.triangular_solve(
                P[:, :w_pad, :], rhs[..., None], left_side=True, lower=True,
                transpose_a=True, unit_diagonal=True,
            )[..., 0]
        x = x.at[bk.cols_idx.reshape(-1)].set(xj.reshape(-1))
        x = x.at[n].set(0.0)
    return x[:-1][bs.iperm]


def bucket_signs(bs: BucketedSymbolic, signs: np.ndarray) -> List[np.ndarray]:
    """Expected pivot signs per schedule-item column (original order ->
    padded layout); padding columns expect +1.  Host-side, once."""
    sp_perm = np.concatenate([np.asarray(signs)[bs.perm], [1.0]])
    return [sp_perm[item.cols_idx] for item in bs.schedule]


def factor_ok_batched_ldl(factors, expected_signs) -> jax.Array:
    """Inertia check (reference is_inertia_correct, normalkkt.jl:132-134
    generalized): every pivot finite, nonzero, and of the sign quasi-
    definiteness predicts (+ primal block, - dual block)."""
    _, dvecs, _ = factors
    ok = jnp.asarray(True)
    for d, s in zip(dvecs, expected_signs):
        ok = ok & jnp.all(jnp.isfinite(d)) & jnp.all(d * jnp.asarray(s) > 0)
    return ok
