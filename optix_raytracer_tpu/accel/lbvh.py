"""On-device LBVH construction (Karras 2012) + threaded (skip-pointer) layout.

Replaces `optixAccelBuild` / `optixAccelCompact` for triangle GAS builds
(`include/optix_host.h:562,670`): Morton-code sort → binary radix tree
topology → bottom-up AABB refit → DFS reordering with escape ("skip")
pointers. Every stage is a fixed-depth data-parallel jnp program, so the
build runs on device under jit — including per-frame rebuilds for dynamic
geometry (`SDK/optixDynamicGeometry/optixDynamicGeometry.cpp:439-460`).

The threaded layout is a wavefront-friendly traversal structure: a ray carries a
single int32 node pointer; "descend" = ptr+1, "skip subtree" = escape index.
No stacks, no divergence — just vectorized pointer updates
(accel/traverse.py). Compaction (`optixAccelCompact`) is a no-op: the arrays
are dense by construction.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from ..core import pytree

from .geometry import TriangleGeometry
from .morton import morton3d

_MAX_DEPTH_SWEEPS = 64  # ≥ max radix-tree depth for n ≤ 2^32 leaves


@pytree.dataclass
class LBVH:
    """Threaded BVH over one TriangleGeometry, in DFS order.

    node_lo/node_hi: [2n-1, 3] AABBs; node_skip: [2n-1] escape index
    (2n-1 = END past the last node); node_prim: [2n-1] leaf triangle id
    (-1 for internal nodes).
    """
    node_lo: jnp.ndarray
    node_hi: jnp.ndarray
    node_skip: jnp.ndarray
    node_prim: jnp.ndarray

    @property
    def num_nodes(self):
        return self.node_prim.shape[0]

    @classmethod
    def empty(cls):
        return cls(node_lo=jnp.zeros((0, 3), jnp.float32),
                   node_hi=jnp.zeros((0, 3), jnp.float32),
                   node_skip=jnp.zeros((0,), jnp.int32),
                   node_prim=jnp.zeros((0,), jnp.int32))


def _delta(codes, i, j, n):
    """Common-prefix length between sorted keys i and j (OOB → -1).

    Keys are (morton, index) pairs so duplicates stay distinct:
    delta = clz(m_i ^ m_j), or 32 + clz(i ^ j) on equal codes.
    """
    oob = (j < 0) | (j >= n)
    j_c = jnp.clip(j, 0, n - 1)
    mi = codes[i]
    mj = codes[j_c]
    x = mi ^ mj
    idx_x = (i ^ j_c).astype(jnp.uint32)
    d = jnp.where(x == 0,
                  32 + (31 - _log2_floor(idx_x)),
                  31 - _log2_floor(x))
    return jnp.where(oob, -1, d)


def _log2_floor(x):
    """floor(log2(x)) for uint32 (x=0 → -1): exact, via count-leading-zeros.

    Must be exact: the float-exponent trick rounds UP for values just below
    a power of two (>= 2^24), which makes the Karras delta inconsistent
    across pairs and yields invalid radix trees (duplicated/missing leaves).
    """
    xi = x.astype(jnp.uint32).astype(jnp.int32)
    return jnp.where(xi == 0, -1, 31 - jax.lax.clz(xi))


def _build_topology(codes, n):
    """Karras radix-tree: children of each internal node i ∈ [0, n-2].

    Unified node indexing: internal node j → index j; leaf j → (n-1) + j.
    All searches exploit that common-prefix length is non-increasing with
    distance in sorted key order, so plain descending-power-of-two binary
    searches (fixed 31 steps) replace the paper's doubling phase.
    """
    i = jnp.arange(n - 1)

    d = jnp.sign(_delta(codes, i, i + 1, n) - _delta(codes, i, i - 1, n))
    d = jnp.where(d == 0, 1, d).astype(jnp.int32)
    delta_min = _delta(codes, i, i - d, n)

    # range length: largest l with delta(i, i + l*d) > delta_min
    l = jnp.zeros(n - 1, jnp.int32)
    for k in range(30, -1, -1):
        cand = l + (1 << k)
        ok = _delta(codes, i, i + cand * d, n) > delta_min
        l = jnp.where(ok, cand, l)
    j = i + l * d

    # split: largest s ≤ l-1 with delta(i, i + s*d) > delta(i, j)
    delta_node = _delta(codes, i, j, n)
    s = jnp.zeros(n - 1, jnp.int32)
    for k in range(30, -1, -1):
        cand = s + (1 << k)
        ok = (cand <= l - 1) & (_delta(codes, i, i + cand * d, n) > delta_node)
        s = jnp.where(ok, cand, s)
    gamma = i + s * d + jnp.minimum(d, 0)

    low = jnp.minimum(i, j)
    high = jnp.maximum(i, j)
    left_is_leaf = low == gamma
    right_is_leaf = high == gamma + 1
    left = jnp.where(left_is_leaf, (n - 1) + gamma, gamma)
    right = jnp.where(right_is_leaf, (n - 1) + gamma + 1, gamma + 1)
    return left, right


@functools.partial(jax.jit)
def build_lbvh(geom: TriangleGeometry) -> LBVH:
    """Build the threaded LBVH for a triangle geometry."""
    v0, e1, e2 = geom.v0, geom.e1, geom.e2
    n = geom.num_triangles
    if n == 1:
        lo = jnp.minimum(v0, jnp.minimum(v0 + e1, v0 + e2))
        hi = jnp.maximum(v0, jnp.maximum(v0 + e1, v0 + e2))
        return LBVH(node_lo=lo, node_hi=hi,
                    node_skip=jnp.asarray([1], jnp.int32),
                    node_prim=jnp.asarray([0], jnp.int32))

    tri_lo = jnp.minimum(v0, jnp.minimum(v0 + e1, v0 + e2))
    tri_hi = jnp.maximum(v0, jnp.maximum(v0 + e1, v0 + e2))
    centroid = 0.5 * (tri_lo + tri_hi)
    scene_lo = jnp.min(tri_lo, axis=0)
    scene_hi = jnp.max(tri_hi, axis=0)

    codes = morton3d(centroid, scene_lo, scene_hi)
    order = jnp.argsort(codes)
    codes_sorted = codes[order]

    left, right = _build_topology(codes_sorted, n)     # [n-1] child encodings

    num_internal = n - 1
    num_nodes = 2 * n - 1
    # Unified node indexing: internal i ∈ [0, n-2]; leaf j → (n-1)+j.
    # parent pointers
    parent = jnp.full(num_nodes, -1, jnp.int32)
    parent = parent.at[left].set(jnp.arange(num_internal, dtype=jnp.int32))
    parent = parent.at[right].set(jnp.arange(num_internal, dtype=jnp.int32))

    is_left_child = jnp.zeros(num_nodes, bool).at[left].set(True)

    # leaf data (sorted order)
    leaf_prim = order.astype(jnp.int32)
    leaf_lo = tri_lo[order]
    leaf_hi = tri_hi[order]

    # --- bottom-up AABB refit + subtree sizes via fixed sweeps ---
    lo = jnp.full((num_nodes, 3), jnp.inf, jnp.float32)
    hi = jnp.full((num_nodes, 3), -jnp.inf, jnp.float32)
    lo = lo.at[num_internal:].set(leaf_lo)
    hi = hi.at[num_internal:].set(leaf_hi)
    size = jnp.zeros(num_nodes, jnp.int32).at[num_internal:].set(1)

    def up_body(_, carry):
        lo, hi, size = carry
        new_lo = jnp.minimum(lo[left], lo[right])
        new_hi = jnp.maximum(hi[left], hi[right])
        new_size = size[left] + size[right]
        lo = lo.at[:num_internal].set(new_lo)
        hi = hi.at[:num_internal].set(new_hi)
        size = size.at[:num_internal].set(new_size)
        return lo, hi, size

    # Tree depth ≤ effective key length (30-bit morton + index tiebreak ⇒ 62)
    # and ≤ n-1; +2 margin lets the dependent skip-pointer sweep settle.
    sweeps = min(_MAX_DEPTH_SWEEPS, n) + 2
    lo, hi, size = jax.lax.fori_loop(0, sweeps, up_body, (lo, hi, size))

    # --- DFS position + skip pointer via fixed top-down sweeps ---
    # dfs(root)=0; dfs(left)=dfs(p)+1; dfs(right)=dfs(p)+1+size(left child).
    # skip(root)=num_nodes; skip(left)=dfs(right sibling); skip(right)=skip(p).
    sibling = jnp.zeros(num_nodes, jnp.int32)
    sibling = sibling.at[left].set(right)
    sibling = sibling.at[right].set(left)

    dfs = jnp.zeros(num_nodes, jnp.int32)
    skip = jnp.full(num_nodes, num_nodes, jnp.int32)

    def down_body(_, carry):
        dfs, skip = carry
        p = jnp.maximum(parent, 0)
        has_parent = parent >= 0
        my_dfs_left = dfs[p] + 1
        sib = sibling
        # size of left sibling subtree: for a right child, left sibling = sib
        sib_size = 2 * size[sib] - 1   # nodes in sibling subtree
        my_dfs_right = dfs[p] + 1 + sib_size
        new_dfs = jnp.where(is_left_child, my_dfs_left, my_dfs_right)
        new_skip = jnp.where(is_left_child, dfs[sib], skip[p])
        dfs = jnp.where(has_parent, new_dfs, dfs)
        skip = jnp.where(has_parent, new_skip, skip)
        return dfs, skip

    dfs, skip = jax.lax.fori_loop(0, sweeps, down_body, (dfs, skip))

    # scatter into DFS order
    node_lo = jnp.zeros((num_nodes, 3), jnp.float32).at[dfs].set(lo)
    node_hi = jnp.zeros((num_nodes, 3), jnp.float32).at[dfs].set(hi)
    node_skip = jnp.zeros(num_nodes, jnp.int32).at[dfs].set(skip)
    prim = jnp.concatenate([jnp.full(num_internal, -1, jnp.int32), leaf_prim])
    node_prim = jnp.zeros(num_nodes, jnp.int32).at[dfs].set(prim)

    return LBVH(node_lo=node_lo, node_hi=node_hi, node_skip=node_skip,
                node_prim=node_prim)
