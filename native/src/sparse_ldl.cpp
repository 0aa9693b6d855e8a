// Sparse symmetric analysis + up-looking LDL^T factorization.
//
// Native CPU backend of the framework's sparse linear-solver layer: the
// equivalent of the reference's LDLFactorizations.jl /CHOLMOD
// dependency (reference SURVEY §2.4: L0 direct solvers).  Exposed through a
// C ABI consumed via ctypes (madqp_tpu/native/__init__.py).
//
// Contents:
//   * elimination tree + postorder + column counts for A (upper CSC pattern)
//   * minimum-degree ordering (simple external-degree variant with
//     indistinguishable-node mass elimination)
//   * symbolic LDL (fixed pattern) + numeric up-looking factorization with
//     a `factorized` success probe (reference src/utils.jl:54-62 analog)
//   * triangular solves L D L' x = b
//
// The algorithms are textbook (Davis, "Direct Methods for Sparse Linear
// Systems") re-implemented from scratch for this framework.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Elimination tree of A (pattern of upper triangle in CSC: Ap, Ai with
// entries i <= j for column j).  parent[j] = etree parent or -1.
// ---------------------------------------------------------------------------
void madqp_etree(int n, const int64_t* Ap, const int32_t* Ai, int32_t* parent) {
  std::vector<int32_t> ancestor(n, -1);
  for (int j = 0; j < n; ++j) {
    parent[j] = -1;
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int i = Ai[p];
      // walk from i up to the root of its subtree, path-compressing
      while (i != -1 && i < j) {
        int next = ancestor[i];
        ancestor[i] = j;
        if (next == -1) parent[i] = j;
        i = next;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Postorder of the elimination tree.
// ---------------------------------------------------------------------------
void madqp_postorder(int n, const int32_t* parent, int32_t* post) {
  std::vector<int32_t> head(n, -1), next(n, -1), stack(n);
  // build child lists (reverse order so traversal is natural)
  for (int j = n - 1; j >= 0; --j) {
    int p = parent[j];
    if (p != -1) {
      next[j] = head[p];
      head[p] = j;
    }
  }
  int k = 0;
  for (int root = 0; root < n; ++root) {
    if (parent[root] != -1) continue;
    int top = 0;
    stack[top] = root;
    while (top >= 0) {
      int j = stack[top];
      int child = head[j];
      if (child == -1) {
        post[k++] = j;
        --top;
      } else {
        head[j] = next[child];
        stack[++top] = child;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Column counts of the Cholesky factor of A (upper CSC pattern) using the
// skeleton-matrix technique on the postordered etree (simplified quadratic
// fallback-free version adequate for the problem sizes handled host-side).
// Returns counts[j] = nnz(L(:, j)) including the diagonal.
// ---------------------------------------------------------------------------
void madqp_col_counts(int n, const int64_t* Ap, const int32_t* Ai,
                      const int32_t* parent, int32_t* counts) {
  // counts via row-subtree traversal with marking: O(nnz(L)) style walk.
  std::vector<int32_t> mark(n, -1);
  for (int j = 0; j < n; ++j) counts[j] = 1;  // diagonal
  for (int j = 0; j < n; ++j) {
    mark[j] = j;
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int i = Ai[p];
      if (i >= j) continue;
      // walk up the etree from i until reaching a marked node
      while (mark[i] != j) {
        mark[i] = j;
        counts[i] += 1;  // column i's factor gains row j
        i = parent[i];
        if (i == -1) break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Minimum-degree ordering (external degree, with mass elimination of
// indistinguishable supervariables folded in lazily).  perm[k] = original
// index of the k-th pivot.  A given as FULL symmetric pattern in CSC
// (both triangles), no self-loops required.
// ---------------------------------------------------------------------------
void madqp_amd_order(int n, const int64_t* Ap, const int32_t* Ai,
                     int32_t* perm) {
  // Quotient-graph-free simple minimum degree: maintain adjacency sets.
  std::vector<std::vector<int32_t>> adj(n);
  for (int j = 0; j < n; ++j) {
    adj[j].reserve(Ap[j + 1] - Ap[j]);
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int i = Ai[p];
      if (i != j) adj[j].push_back(i);
    }
    std::sort(adj[j].begin(), adj[j].end());
    adj[j].erase(std::unique(adj[j].begin(), adj[j].end()), adj[j].end());
  }
  std::vector<char> eliminated(n, 0);
  std::vector<int32_t> degree(n);
  for (int j = 0; j < n; ++j) degree[j] = (int32_t)adj[j].size();

  // Bucket queue keyed by degree: O(1) amortized min selection with lazy
  // deletion (nodes are re-inserted on degree change; stale entries skipped).
  std::vector<std::vector<int32_t>> bucket(n + 1);
  std::vector<int32_t> in_bucket(n);
  for (int j = 0; j < n; ++j) {
    bucket[degree[j]].push_back(j);
    in_bucket[j] = degree[j];
  }
  int mindeg = 0;

  for (int k = 0; k < n; ++k) {
    int best = -1;
    while (best == -1) {
      while (mindeg <= n && bucket[mindeg].empty()) ++mindeg;
      auto& b = bucket[mindeg];
      int cand = b.back();
      b.pop_back();
      // skip stale entries (eliminated or degree changed)
      if (!eliminated[cand] && in_bucket[cand] == mindeg &&
          degree[cand] == mindeg) {
        best = cand;
      }
      if (b.empty() && best == -1) continue;
    }
    perm[k] = best;
    eliminated[best] = 1;
    // form the clique of best's remaining neighbors
    std::vector<int32_t> nbrs;
    nbrs.reserve(adj[best].size());
    for (int i : adj[best])
      if (!eliminated[i]) nbrs.push_back(i);
    for (int i : nbrs) {
      // merge nbrs into adj[i]
      std::vector<int32_t> merged;
      merged.reserve(adj[i].size() + nbrs.size());
      std::set_union(adj[i].begin(), adj[i].end(), nbrs.begin(), nbrs.end(),
                     std::back_inserter(merged));
      // drop eliminated nodes and self
      merged.erase(
          std::remove_if(merged.begin(), merged.end(),
                         [&](int32_t v) { return eliminated[v] || v == i; }),
          merged.end());
      adj[i] = std::move(merged);
      int32_t nd = (int32_t)adj[i].size();
      if (nd != degree[i]) {
        degree[i] = nd;
        bucket[nd].push_back(i);
        in_bucket[i] = nd;
        if (nd < mindeg) mindeg = nd;
      }
    }
    adj[best].clear();
    adj[best].shrink_to_fit();
  }
}

// ---------------------------------------------------------------------------
// Element-based approximate minimum degree (quotient-graph style).
//
// Unlike madqp_amd_order above (explicit clique merging, O(fill) memory and
// time — fine below ~3k), this maintains the quotient graph: eliminating a
// pivot creates an *element* whose member list represents the clique
// implicitly; neighbor degrees use AMD's upper-bound estimate
// |adj_var| + sum |Le|.  Memory stays O(nnz) and per-pivot work is
// proportional to the affected lists.  perm[k] = original index of pivot k.
// ---------------------------------------------------------------------------
void madqp_amd_elem_order(int n, const int64_t* Ap, const int32_t* Ai,
                          int32_t* perm) {
  std::vector<std::vector<int32_t>> adj(n);       // variable-variable edges
  std::vector<std::vector<int32_t>> elems_of(n);  // element ids touching var
  std::vector<std::vector<int32_t>> members;      // element id -> member vars
  members.reserve(n);
  for (int j = 0; j < n; ++j) {
    adj[j].reserve(Ap[j + 1] - Ap[j]);
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int i = Ai[p];
      if (i != j) adj[j].push_back(i);
    }
    std::sort(adj[j].begin(), adj[j].end());
    adj[j].erase(std::unique(adj[j].begin(), adj[j].end()), adj[j].end());
  }
  std::vector<char> eliminated(n, 0);
  std::vector<char> dead_elem;  // element absorbed?
  std::vector<int64_t> approx_deg(n);
  for (int j = 0; j < n; ++j) approx_deg[j] = (int64_t)adj[j].size();

  // bucket queue over clamped degree
  auto clampd = [&](int64_t d) { return (int32_t)std::min<int64_t>(d, n); };
  std::vector<std::vector<int32_t>> bucket(n + 1);
  for (int j = 0; j < n; ++j) bucket[clampd(approx_deg[j])].push_back(j);
  int mindeg = 0;

  std::vector<int32_t> stamp(n, -1);
  std::vector<int32_t> Lv;  // scratch: members of the new element
  Lv.reserve(64);

  for (int k = 0; k < n; ++k) {
    // pop the minimum-degree live variable (lazy deletion)
    int v = -1;
    while (v == -1) {
      while (mindeg <= n && bucket[mindeg].empty()) ++mindeg;
      auto& b = bucket[mindeg];
      int cand = b.back();
      b.pop_back();
      if (!eliminated[cand] && clampd(approx_deg[cand]) == mindeg) v = cand;
    }
    perm[k] = v;
    eliminated[v] = 1;

    // Lv = (adj[v] ∪ union of member lists of v's elements) \ eliminated
    Lv.clear();
    int tag = k;
    stamp[v] = tag;
    for (int u : adj[v]) {
      if (!eliminated[u] && stamp[u] != tag) {
        stamp[u] = tag;
        Lv.push_back(u);
      }
    }
    for (int e : elems_of[v]) {
      if (dead_elem[e]) continue;
      for (int u : members[e]) {
        if (!eliminated[u] && stamp[u] != tag) {
          stamp[u] = tag;
          Lv.push_back(u);
        }
      }
      dead_elem[e] = 1;  // absorbed into the new element
    }
    adj[v].clear();
    adj[v].shrink_to_fit();
    elems_of[v].clear();

    if (Lv.empty()) continue;
    int e_new = (int)members.size();
    members.push_back(Lv);
    dead_elem.push_back(0);

    for (int u : Lv) {
      // prune variable edges now covered by the element (incl. v) and dead
      auto& au = adj[u];
      size_t w = 0;
      for (size_t r = 0; r < au.size(); ++r) {
        int x = au[r];
        if (eliminated[x] || stamp[x] == tag) continue;  // covered/eliminated
        au[w++] = x;
      }
      au.resize(w);
      // drop absorbed elements, add the new one
      auto& eu = elems_of[u];
      size_t w2 = 0;
      for (size_t r = 0; r < eu.size(); ++r)
        if (!dead_elem[eu[r]]) eu[w2++] = eu[r];
      eu.resize(w2);
      eu.push_back(e_new);
      // AMD-style degree upper bound
      int64_t d = (int64_t)au.size();
      for (int e : eu) d += (int64_t)members[e].size() - 1;
      approx_deg[u] = d;
      int32_t cd = clampd(d);
      bucket[cd].push_back(u);
      if (cd < mindeg) mindeg = cd;
    }
  }
}

// ---------------------------------------------------------------------------
// Symbolic LDL: given upper-CSC pattern + etree + column counts, build the
// column pointers Lp (size n+1).  The row patterns are produced during the
// numeric factorization (up-looking, identical every call).
// ---------------------------------------------------------------------------
void madqp_ldl_symbolic(int n, const int32_t* counts, int64_t* Lp) {
  Lp[0] = 0;
  for (int j = 0; j < n; ++j) Lp[j + 1] = Lp[j] + (counts[j] - 1);
}

// ---------------------------------------------------------------------------
// Numeric up-looking LDL^T.  A in upper CSC (Ap, Ai, Ax with i <= j).
// Outputs: Li/Lx (strictly-lower columns, capacity from Lp), D (n).
// Lnz[j] = current count in column j.  Returns the number of nonzero pivots
// computed; a value < n means breakdown (zero pivot) at that column —
// the `is_factorized` probe.
// ---------------------------------------------------------------------------
int madqp_ldl_numeric(int n, const int64_t* Ap, const int32_t* Ai,
                      const double* Ax, const int32_t* parent,
                      const int64_t* Lp, int32_t* Li, double* Lx, double* D,
                      int32_t* Lnz, int32_t* pattern_ws, int32_t* flag_ws,
                      double* y_ws) {
  // workspaces: pattern_ws (2n: stack + reach), flag_ws (n), y_ws (n)
  int32_t* stack = pattern_ws + n;  // scratch for one etree walk
  for (int j = 0; j < n; ++j) {
    y_ws[j] = 0.0;
    flag_ws[j] = -1;
    Lnz[j] = 0;
  }
  for (int k = 0; k < n; ++k) {
    // Scatter column k of A (upper triangle) into y and compute the row-k
    // pattern of L as the union of etree paths i -> ... -> k, stored in
    // pattern_ws[top..n-1] in topological (ascending-depth) order.
    int top = n;
    flag_ws[k] = k;
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int i = Ai[p];
      if (i > k) continue;
      y_ws[i] += Ax[p];
      int len = 0;
      while (i != -1 && flag_ws[i] != k) {
        stack[len++] = i;
        flag_ws[i] = k;
        i = parent[i];
      }
      while (len > 0) pattern_ws[--top] = stack[--len];
    }
    // Numeric sweep over the pattern in topological order.
    D[k] = y_ws[k];
    y_ws[k] = 0.0;
    for (int t = top; t < n; ++t) {
      int i = pattern_ws[t];
      double yi = y_ws[i];
      y_ws[i] = 0.0;
      double l_ki = yi / D[i];
      for (int64_t p = Lp[i]; p < Lp[i] + Lnz[i]; ++p) {
        y_ws[Li[p]] -= Lx[p] * yi;
      }
      D[k] -= l_ki * yi;
      int64_t pos = Lp[i] + Lnz[i];
      Li[pos] = k;
      Lx[pos] = l_ki;
      Lnz[i] += 1;
    }
    if (D[k] == 0.0) return k;  // breakdown
  }
  return n;
}

// ---------------------------------------------------------------------------
// Solve L D L' x = b in place (x starts as b).
// ---------------------------------------------------------------------------
void madqp_ldl_solve(int n, const int64_t* Lp, const int32_t* Li,
                     const double* Lx, const int32_t* Lnz, const double* D,
                     double* x) {
  for (int j = 0; j < n; ++j) {
    double xj = x[j];
    for (int64_t p = Lp[j]; p < Lp[j] + Lnz[j]; ++p) x[Li[p]] -= Lx[p] * xj;
  }
  for (int j = 0; j < n; ++j) x[j] /= D[j];
  for (int j = n - 1; j >= 0; --j) {
    double xj = x[j];
    for (int64_t p = Lp[j]; p < Lp[j] + Lnz[j]; ++p) xj -= Lx[p] * x[Li[p]];
    x[j] = xj;
  }
}

}  // extern "C"
