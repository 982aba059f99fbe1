"""Fill-reducing ordering for the block-sparse Cholesky.

The reference's sparse factorization delegates ordering to CHOLMOD:
cholmod_analyze picks a fill-reducing permutation (AMD family) before the
symbolic factorization (reference dogleg.c:649-654). Without one, simplicial
Cholesky can fill catastrophically — an "arrow" matrix whose dense row comes
first factors completely full, while the reverse order has zero fill.

This module provides the exact-minimum-degree elimination-graph ordering:
repeatedly eliminate the minimum-degree vertex of the (block) adjacency
graph, forming a clique among its neighbors. Native C++ fast path
(csrc/symbolic.cpp: mindeg_order) with a pure-Python fallback of identical
output. Runs once per sparsity pattern on the host, like the rest of the
symbolic phase.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import Optional

import numpy as np

from libdogleg_tpu.native.loader import get_lib


def _mindeg_python(rows: np.ndarray, cols: np.ndarray,
                   n: int) -> np.ndarray:
    """Pure-Python exact minimum degree (lazy-heap), identical tie-breaking
    (smallest current degree, then smallest vertex index) to the native
    kernel."""
    adj = [set() for _ in range(n)]
    for i, j in zip(rows, cols):
        i, j = int(i), int(j)
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    heap = [(len(adj[v]), v) for v in range(n)]
    heapq.heapify(heap)
    eliminated = np.zeros(n, bool)
    perm = np.empty(n, np.int32)
    for k in range(n):
        v = -1
        while heap:
            d, u = heapq.heappop(heap)
            if not eliminated[u] and len(adj[u]) == d:
                v = u
                break
        if v < 0:
            v = int(np.flatnonzero(~eliminated)[0])
        perm[k] = v
        eliminated[v] = True
        nbrs = sorted(adj[v])
        for u in nbrs:
            adj[u].discard(v)
        for a in range(len(nbrs)):
            for c in range(a + 1, len(nbrs)):
                adj[nbrs[a]].add(nbrs[c])
                adj[nbrs[c]].add(nbrs[a])
        for u in nbrs:
            heapq.heappush(heap, (len(adj[u]), u))
        adj[v].clear()
    return perm


def mindeg_ordering(rows: np.ndarray, cols: np.ndarray,
                    n: int) -> np.ndarray:
    """Fill-reducing permutation for the symmetric pattern given by the
    stored (row, col) coordinate lists (either triangle; diagonal entries
    ignored). Returns perm with perm[k] = original index eliminated k-th."""
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    lib = get_lib()
    if lib is not None:
        perm = np.empty(n, np.int32)
        lib.mindeg_order(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int64(rows.shape[0]), np.int32(n),
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return perm
    return _mindeg_python(rows, cols, n)


def rcm_ordering(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee: the bandwidth-minimizing companion to
    supernodal amalgamation (libdogleg_tpu.supernodal). Minimum degree
    minimizes fill but scatters structurally-related columns through the
    elimination order, which makes fixed-width column grouping couple
    distant nodes; RCM keeps consecutive columns adjacent in the graph, so
    grouped supernodes stay banded. BFS from a minimum-degree start node of
    each component, neighbors visited in degree order, result reversed."""
    adj = [[] for _ in range(n)]
    for i, j in zip(np.asarray(rows), np.asarray(cols)):
        i, j = int(i), int(j)
        if i != j:
            adj[i].append(j)
            adj[j].append(i)
    deg = np.array([len(a) for a in adj])
    for a in adj:
        a.sort(key=lambda v: deg[v])
    import collections
    visited = np.zeros(n, bool)
    order = []
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        queue = collections.deque([int(start)])
        visited[start] = True
        while queue:
            v = queue.popleft()
            order.append(v)
            for u in adj[v]:
                if not visited[u]:
                    visited[u] = True
                    queue.append(u)
    return np.asarray(order[::-1], np.int32)


def nd_ordering(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Nested dissection by recursive level-set bisection: the
    elimination-tree-HEIGHT-minimizing companion to the level-scheduled
    factorization (sparse_cholesky). Minimum degree and RCM minimize fill
    and bandwidth but leave chain-like quotient graphs with O(n)
    sequential elimination levels; on an accelerator the factorization's cost is
    the level COUNT (each level is one batched dispatch), so a log-depth
    tree is worth modest extra fill. Halves are eliminated first
    (recursively), the separator last: perm = [A..., B..., sep...].

    Separators come from BFS level structures (pseudo-peripheral start,
    split at the cumulative-count median) — the classic metis-free
    construction; for band/grid patterns the separators are exact
    cross-sections and the tree is balanced."""
    adj = [[] for _ in range(n)]
    for i, j in zip(np.asarray(rows), np.asarray(cols)):
        i, j = int(i), int(j)
        if i != j:
            adj[i].append(j)
            adj[j].append(i)
    import collections
    out = []

    def bfs_levels(start, members):
        level = {start: 0}
        q = collections.deque([start])
        order = [start]
        while q:
            v = q.popleft()
            for u in adj[v]:
                if u in members and u not in level:
                    level[u] = level[v] + 1
                    q.append(u)
                    order.append(u)
        return level, order

    def dissect(nodes):
        if len(nodes) <= 2:
            out.extend(sorted(nodes))
            return
        members = set(nodes)
        remaining = set(nodes)
        while remaining:
            seed = min(remaining)
            lv1, comp = bfs_levels(seed, remaining)
            comp_set = set(comp)
            remaining -= comp_set
            if len(comp) <= 2:
                out.extend(sorted(comp))
                continue
            # pseudo-peripheral restart from the farthest node
            far = comp[-1]
            lv, _ = bfs_levels(far, comp_set)
            nlv = max(lv.values()) + 1
            if nlv <= 2:
                # (near-)clique: no useful separator
                out.extend(sorted(comp))
                continue
            counts = np.zeros(nlv, np.int64)
            for v in comp:
                counts[lv[v]] += 1
            half = len(comp) // 2
            med = int(np.searchsorted(np.cumsum(counts), half))
            med = min(max(med, 1), nlv - 2)
            A = [v for v in comp if lv[v] < med]
            S = [v for v in comp if lv[v] == med]
            B = [v for v in comp if lv[v] > med]
            dissect(A)
            dissect(B)
            out.extend(sorted(S))

    dissect(list(range(n)))
    return np.asarray(out, np.int32)


def resolve_ordering(ordering, rows: np.ndarray, cols: np.ndarray,
                     n: int) -> np.ndarray:
    """Normalize an ordering spec — "mindeg"/"amd", "rcm", "natural", or an
    explicit permutation array — to a perm array (perm[k] = original index
    k-th in elimination order). None means "the default fill-reducing
    choice" (mindeg), NOT natural: higher layers pass None through for
    auto-selection, and silently disabling fill reduction is the one wrong
    answer."""
    if ordering is None:
        ordering = "mindeg"
    if isinstance(ordering, str):
        if ordering == "natural":
            return np.arange(n, dtype=np.int32)
        if ordering in ("mindeg", "amd"):
            return mindeg_ordering(rows, cols, n)
        if ordering == "rcm":
            return rcm_ordering(rows, cols, n)
        if ordering == "nd":
            return nd_ordering(rows, cols, n)
        raise ValueError(f"unknown ordering {ordering!r}")
    perm = np.asarray(ordering, np.int32)
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError(
            f"explicit ordering must be a permutation of 0..{n - 1}; "
            f"got shape {perm.shape}")
    return perm
