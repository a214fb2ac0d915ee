"""Distributed Schur-complement pose-graph solve over a device mesh.

The reference solves its pose graph with a single-host sparse LDLT
(reference PoseGraphOptimizer.cpp:340-348). A SLAM pose graph is a chain
of odometry factors plus a few loop-closure edges, so its Gauss-Newton
normal matrix is block-tridiagonal (6x6 blocks) plus a handful of
off-band entries. The distributed design (north star / SURVEY.md §2.4):

  * keyframes are partitioned into contiguous blocks, one per device,
    with partition boundaries placed AT loop-edge endpoints (host-side
    planning — loops are known before the solve), so every off-band edge
    couples only SEPARATOR variables;
  * each device eliminates its interior chain by block-tridiagonal
    forward elimination (a lax.scan), producing a 2x2-block Schur
    contribution onto its two separators;
  * contributions are all-gathered across devices (NVLink/NCCL on a
    multi-GPU host; tiny: (D+1) x 6 x 6 blocks),
    the reduced separator system (+ loop edges) is solved replicated,
    and interiors back-substitute locally in parallel.

This file provides both the single-device block-tridiagonal solver (the
exact baseline) and the shard_map-partitioned version, operating on the
same factor linearization as models/pose_graph.py.
"""
from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["plan_partition", "dense_solve", "block_tridiag_solve",
           "schur_partitioned_solve", "make_plan", "gn_optimize_device"]


def plan_partition(n: int, n_blocks: int, loop_edges: Sequence[Tuple[int, int]]):
    """Choose separator indices: evenly spaced block boundaries, snapped to
    include every loop-edge endpoint. Returns sorted separator indices
    (always includes n-1). Host-side planning."""
    seps = set(int(round(i * (n - 1) / n_blocks)) for i in range(1, n_blocks + 1))
    for a, b in loop_edges:
        seps.add(int(a))
        seps.add(int(b))
    # Pose 0 stays interior of the first block (prior-pinned) UNLESS a loop
    # edge references it — schur_partitioned_solve requires every loop-edge
    # endpoint to be a separator, and loops back to keyframe 0 are the
    # common loop-back-to-start case (ADVICE round-1 item 1).
    if not any(0 in (int(a), int(b)) for a, b in loop_edges):
        seps.discard(0)
    return sorted(seps)


def dense_solve(diag, off, b, loop_edges=(), loop_blocks=()):
    """Reference dense solve of the block-tridiagonal(+loops) system, for
    testing. diag (n,6,6), off (n-1,6,6) with off[i] = H[i, i+1]."""
    n = diag.shape[0]
    H = np.zeros((n * 6, n * 6))
    for i in range(n):
        H[i*6:(i+1)*6, i*6:(i+1)*6] = diag[i]
    for i in range(n - 1):
        H[i*6:(i+1)*6, (i+1)*6:(i+2)*6] = off[i]
        H[(i+1)*6:(i+2)*6, i*6:(i+1)*6] = off[i].T
    for (a, bb), (Baa, Bab, Bbb) in zip(loop_edges, loop_blocks):
        H[a*6:(a+1)*6, a*6:(a+1)*6] += Baa
        H[a*6:(a+1)*6, bb*6:(bb+1)*6] += Bab
        H[bb*6:(bb+1)*6, a*6:(a+1)*6] += Bab.T
        H[bb*6:(bb+1)*6, bb*6:(bb+1)*6] += Bbb
    return np.linalg.solve(H, np.asarray(b).reshape(-1)).reshape(n, 6)


@jax.jit
def block_tridiag_solve(diag: jax.Array, off: jax.Array, b: jax.Array):
    """Single-device block-Thomas solve: diag (n,6,6), off (n-1,6,6)
    (off[i] = coupling of i to i+1), b (n,6). O(n) sequential scan —
    the on-device exact baseline for chain graphs."""
    n = diag.shape[0]
    off_p = jnp.concatenate([off, jnp.zeros((1, 6, 6), diag.dtype)])

    def fwd(carry, inp):
        C_prev, d_prev = carry          # C = D~^-1 U, d = D~^-1 b~
        D_i, U_i, b_i, L_i = inp        # L_i = off[i-1]^T = H[i, i-1]
        Dt = D_i - L_i @ C_prev
        bt = b_i - (L_i @ d_prev[:, None])[:, 0]
        C_i = jnp.linalg.solve(Dt, U_i)
        d_i = jnp.linalg.solve(Dt, bt[:, None])[:, 0]
        return (C_i, d_i), (C_i, d_i)

    L = jnp.concatenate([jnp.zeros((1, 6, 6), diag.dtype),
                         jnp.swapaxes(off, -1, -2)])
    init = (jnp.zeros((6, 6), diag.dtype), jnp.zeros((6,), diag.dtype))
    _, (C, d) = jax.lax.scan(fwd, init, (diag, off_p, b, L))

    def bwd(x_next, inp):
        C_i, d_i = inp
        x_i = d_i - (C_i @ x_next[:, None])[:, 0]
        return x_i, x_i

    _, xs = jax.lax.scan(bwd, jnp.zeros((6,), diag.dtype), (C, d), reverse=True)
    return xs


def _eliminate_interior(Dint, off_int, bint, Lsep, L_left, U_right, valid):
    """Eliminate one block's interior chain (m interior poses, FRONT-padded
    with identity/zero rows masked by `valid`) onto its (left, right)
    separators.

    Lsep (m,6,6): per-row coupling to the left separator — nonzero only at
    the first valid row, where it equals L_left = H[first_int, sep_l].
    U_right (6,6): coupling of the last interior pose to separator_right
    (H[last_int, sep_r]).

    Returns the Schur contribution (S_ll, S_lr, S_rl, S_rr, r_l, r_r) plus
    the factors needed for back-substitution.
    """
    m = Dint.shape[0]
    off_p = jnp.concatenate([off_int, jnp.zeros((1, 6, 6), Dint.dtype)])
    I = jnp.eye(6, dtype=Dint.dtype)

    # Forward elimination down the interior chain, carrying the mixing of
    # the left separator: x_i = d_i - C_i x_{i+1} - E_i x_l
    def fwd(carry, inp):
        C_prev, E_prev, d_prev = carry
        D_i, U_i, b_i, L_i, Lsep_i, v_i = inp
        Dt = jnp.where(v_i, D_i - L_i @ C_prev, I)
        rhs_b = jnp.where(v_i, b_i - (L_i @ d_prev[:, None])[:, 0], jnp.zeros(6, Dint.dtype))
        rhs_E = jnp.where(v_i, Lsep_i - L_i @ E_prev, jnp.zeros((6, 6), Dint.dtype))
        C_i = jnp.where(v_i, jnp.linalg.solve(Dt, U_i), jnp.zeros((6, 6), Dint.dtype))
        E_i = jnp.linalg.solve(Dt, rhs_E)
        d_i = jnp.linalg.solve(Dt, rhs_b[:, None])[:, 0]
        return (C_i, E_i, d_i), (C_i, E_i, d_i, Dt)

    L = jnp.concatenate([jnp.zeros((1, 6, 6), Dint.dtype),
                         jnp.swapaxes(off_int, -1, -2)])
    init = (jnp.zeros((6, 6), Dint.dtype), jnp.zeros((6, 6), Dint.dtype),
            jnp.zeros((6,), Dint.dtype))
    _, (C, E, d, Dt) = jax.lax.scan(
        fwd, init, (Dint, off_p, bint, L, Lsep, valid))

    # Last valid interior index couples to the right separator. The caller
    # pads so that the LAST row is always the last valid one when the block
    # is non-empty; emptiness handled by `any_valid`.
    any_valid = jnp.any(valid)
    C_last, E_last, d_last = C[-1], E[-1], d[-1]

    # Backward accumulation to express every x_i = g_i - F_i x_l - G_i x_r.
    def bwd(carry, inp):
        F_next, G_next, g_next = carry
        C_i, E_i, d_i, v_i = inp
        F_i = jnp.where(v_i, E_i - C_i @ F_next, jnp.zeros((6, 6), Dint.dtype))
        G_i = jnp.where(v_i, -C_i @ G_next, jnp.zeros((6, 6), Dint.dtype))
        g_i = jnp.where(v_i, d_i - (C_i @ g_next[:, None])[:, 0], jnp.zeros(6, Dint.dtype))
        return (F_i, G_i, g_i), (F_i, G_i, g_i)

    # seed: x_last = d_last - E_last x_l - (Dt_last^-1 U_right) x_r
    Ur_solved = jnp.linalg.solve(Dt[-1], U_right)
    init_b = (E_last, Ur_solved, d_last)
    (_, _, _), (F, G, g) = jax.lax.scan(
        bwd, init_b, (C[:-1], E[:-1], d[:-1], valid[:-1]), reverse=True)
    F = jnp.concatenate([F, E_last[None]])
    G = jnp.concatenate([G, Ur_solved[None]])
    g = jnp.concatenate([g, d_last[None]])

    # Schur contributions: eliminate interior from the separator equations.
    # Separator-left equation gains -L_left^T x_first; right gains
    # -U_right^T x_last. x_first lives at the FIRST VALID row (blocks are
    # front-padded), x_last at the last row.
    Lt = jnp.swapaxes(L_left, -1, -2)
    Ut = jnp.swapaxes(U_right, -1, -2)
    first = jnp.argmax(valid)  # index of first True (0 if none; masked below)
    F0, G0, g0 = F[first], G[first], g[first]
    Fm, Gm, gm = F[-1], G[-1], g[-1]
    z6 = jnp.zeros((6, 6), Dint.dtype)
    S_ll = jnp.where(any_valid, -Lt @ F0, z6)
    S_lr = jnp.where(any_valid, -Lt @ G0, z6)
    S_rl = jnp.where(any_valid, -Ut @ Fm, z6)
    S_rr = jnp.where(any_valid, -Ut @ Gm, z6)
    r_l = jnp.where(any_valid, -(Lt @ g0[:, None])[:, 0], jnp.zeros(6, Dint.dtype))
    r_r = jnp.where(any_valid, -(Ut @ gm[:, None])[:, 0], jnp.zeros(6, Dint.dtype))
    return (S_ll, S_lr, S_rl, S_rr, r_l, r_r), (F, G, g)


def schur_partitioned_solve(diag, off, b, separators: Sequence[int],
                            loop_edges=(), loop_blocks=(), mesh: Mesh = None,
                            mesh_axis: str = "data"):
    """Solve the chain(+separator loop edges) system by separator Schur
    complement. `separators` from plan_partition (each loop endpoint must
    be a separator). When `mesh` is given, interior eliminations and
    back-substitutions run sharded over `mesh_axis` via shard_map;
    otherwise they vmap on one device (same math).

    Returns x (n, 6) float64-or-input-dtype solution.
    """
    diag = jnp.asarray(diag)
    off = jnp.asarray(off)
    b = jnp.asarray(b)
    n = diag.shape[0]
    seps = list(separators)
    assert seps == sorted(seps) and seps[-1] == n - 1
    D = len(seps)  # number of interior blocks == number of separators

    # Interior ranges: block k covers (prev_sep, sep_k) exclusive of both
    # separators; block 0's "left separator" is virtual (no coupling).
    prev = [-1] + seps[:-1]
    max_m = max(max(s - p - 1 for p, s in zip(prev, seps)), 1)

    dtype = diag.dtype
    Dint = np.zeros((D, max_m, 6, 6), dtype)
    Oint = np.zeros((D, max_m - 1, 6, 6), dtype) if max_m > 1 else np.zeros((D, 0, 6, 6), dtype)
    Bint = np.zeros((D, max_m, 6), dtype)
    Lsep = np.zeros((D, max_m, 6, 6), dtype)
    Lleft = np.zeros((D, 6, 6), dtype)
    Uright = np.zeros((D, 6, 6), dtype)
    Valid = np.zeros((D, max_m), bool)

    diag_np = np.asarray(diag)
    off_np = np.asarray(off)
    b_np = np.asarray(b)
    for k, (p, s) in enumerate(zip(prev, seps)):
        m = s - p - 1
        if m == 0:
            continue
        sl = slice(p + 1, s)
        # Pad at the FRONT so the last row is the last interior pose.
        Dint[k, max_m - m:] = diag_np[sl]
        Dint[k, : max_m - m] = np.eye(6, dtype=dtype)
        if m > 1:
            Oint[k, max_m - m: max_m - 1] = off_np[p + 1: s - 1]
        Bint[k, max_m - m:] = b_np[sl]
        Valid[k, max_m - m:] = True
        if p >= 0:
            # H[p+1, p] couples first interior pose to left separator.
            Lleft[k] = off_np[p].T
            Lsep[k, max_m - m] = off_np[p].T
        Uright[k] = off_np[s - 1]

    elim = jax.vmap(_eliminate_interior)
    if mesh is not None:
        elim = jax.shard_map(
            jax.vmap(_eliminate_interior), mesh=mesh,
            in_specs=(P(mesh_axis),) * 7,
            out_specs=((P(mesh_axis),) * 6, (P(mesh_axis),) * 3),
            check_vma=False)
    (S_ll, S_lr, S_rl, S_rr, r_l, r_r), (F, G, g) = elim(
        jnp.asarray(Dint), jnp.asarray(Oint), jnp.asarray(Bint),
        jnp.asarray(Lsep), jnp.asarray(Lleft), jnp.asarray(Uright),
        jnp.asarray(Valid))
    if mesh is not None:
        # replicate the shard_map outputs so the host-side reduced solve
        # can read them on EVERY process (a sharded array is not fully
        # addressable under multi-process jax.distributed)
        from jax.sharding import NamedSharding
        rep = NamedSharding(mesh, P())
        (S_ll, S_lr, S_rl, S_rr, r_l, r_r, F, G, g) = jax.jit(
            lambda *a: a, out_shardings=(rep,) * 9)(
            S_ll, S_lr, S_rl, S_rr, r_l, r_r, F, G, g)

    # ---- reduced separator system (replicated; D x 6 dims) ----
    S_ll, S_lr, S_rl, S_rr = map(np.asarray, (S_ll, S_lr, S_rl, S_rr))
    r_l, r_r = np.asarray(r_l), np.asarray(r_r)
    Hs = np.zeros((D * 6, D * 6), dtype)
    bs = np.zeros(D * 6, dtype)
    sep_of = {s: i for i, s in enumerate(seps)}
    for i, s in enumerate(seps):
        Hs[i*6:(i+1)*6, i*6:(i+1)*6] += diag_np[s]
        bs[i*6:(i+1)*6] += b_np[s]
        # couplings between consecutive separators with empty interiors
        if i + 1 < D and seps[i + 1] == s + 1:
            Hs[i*6:(i+1)*6, (i+1)*6:(i+2)*6] += off_np[s]
            Hs[(i+1)*6:(i+2)*6, i*6:(i+1)*6] += off_np[s].T
    for k in range(D):
        i_r = k
        Hs[i_r*6:(i_r+1)*6, i_r*6:(i_r+1)*6] += S_rr[k]
        bs[i_r*6:(i_r+1)*6] += r_r[k]
        if k > 0:
            i_l = k - 1
            Hs[i_l*6:(i_l+1)*6, i_l*6:(i_l+1)*6] += S_ll[k]
            Hs[i_l*6:(i_l+1)*6, i_r*6:(i_r+1)*6] += S_lr[k]
            Hs[i_r*6:(i_r+1)*6, i_l*6:(i_l+1)*6] += S_rl[k]
            bs[i_l*6:(i_l+1)*6] += r_l[k]
    for (a, bb), (Baa, Bab, Bbb) in zip(loop_edges, loop_blocks):
        ia, ib = sep_of[a], sep_of[bb]
        Hs[ia*6:(ia+1)*6, ia*6:(ia+1)*6] += Baa
        Hs[ia*6:(ia+1)*6, ib*6:(ib+1)*6] += Bab
        Hs[ib*6:(ib+1)*6, ia*6:(ia+1)*6] += Bab.T
        Hs[ib*6:(ib+1)*6, ib*6:(ib+1)*6] += Bbb
    xs = np.linalg.solve(Hs, bs).reshape(D, 6)

    # ---- back-substitution: x_i = g_i - F_i x_left - G_i x_right ----
    F, G, g = np.asarray(F), np.asarray(G), np.asarray(g)
    x = np.zeros((n, 6), dtype)
    for i, s in enumerate(seps):
        x[s] = xs[i]
    for k, (p, s) in enumerate(zip(prev, seps)):
        m = s - p - 1
        if m == 0:
            continue
        xl = xs[sep_of[p]] if p in sep_of else np.zeros(6, dtype)
        xr = xs[sep_of[s]]
        xi = g[k] - F[k] @ xl - G[k] @ xr
        x[p + 1: s] = xi[max_m - m:]
    return x


# ======================================================================
# Device-resident GN (round-2): the whole pose-graph iteration —
# batched factor linearization, interior elimination, the reduced
# separator solve, back-substitution, and SE(3) retraction — runs as ONE
# jitted float64 program (VERDICT round-1 item 6; the round-1 version
# repacked every linearization into numpy per iteration and solved the
# reduced system on the host). The host keeps only graph bookkeeping:
# factor lists -> padded arrays + a partition plan, built once per
# optimize() call.
#
# The GN normal matrix is SPD, so every inner solve here is Cholesky-
# based (the reference uses SimplicialLDLT, PoseGraphOptimizer.cpp:340-348).
# ======================================================================

_LIE_EPS = 1e-10  # reference kEpsLie (PoseGraphOptimizer.cpp:31)


def _spd_solve(A, B):
    """Solve SPD A x = B via Cholesky (batched over leading dims)."""
    L = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False)


def _bskew(v):
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], -1),
        jnp.stack([v[..., 2], z, -v[..., 0]], -1),
        jnp.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _bso3_log(R):
    """Batched SO(3) log, same branch structure as the host so3_log
    (reference SO3_Logmap, PoseGraphOptimizer.cpp:41-58)."""
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    theta = jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < _LIE_EPS
    denom = jnp.where(small, 1.0, 2.0 * jnp.sin(jnp.where(small, 1.0, theta)))
    factor = jnp.where(small, 0.5, theta / denom)
    return w * factor[..., None]


def _bse3_log(R, t):
    """Batched SE(3) log -> [w, u] in GTSAM order (reference SE3_Logmap)."""
    w = _bso3_log(R)
    theta = jnp.linalg.norm(w, axis=-1)
    small = theta < _LIE_EPS
    safe = jnp.where(small, 1.0, theta)
    W = _bskew(w / safe[..., None])
    Wt = jnp.einsum("...ij,...j->...i", W, t)
    WWt = jnp.einsum("...ij,...j->...i", W, Wt)
    tan_half = jnp.tan(0.5 * safe)
    u_big = (t - (0.5 * theta)[..., None] * Wt
             + (1.0 - theta / (2.0 * tan_half))[..., None] * WWt)
    u = jnp.where(small[..., None], t, u_big)
    return jnp.concatenate([w, u], -1)


def _bse3_exp(xi):
    """Batched SE(3) exp [w, u] -> (R, t) (reference SE3_Expmap)."""
    w, u = xi[..., :3], xi[..., 3:]
    theta = jnp.linalg.norm(w, axis=-1)
    small = theta < _LIE_EPS
    safe = jnp.where(small, 1.0, theta)
    W = _bskew(w)
    WW = W @ W
    I = jnp.eye(3, dtype=xi.dtype)
    s, c = jnp.sin(safe), jnp.cos(safe)
    R_big = I + (s / safe)[..., None, None] * W + \
        ((1.0 - c) / (safe * safe))[..., None, None] * WW
    R = jnp.where(small[..., None, None], I + W, R_big)
    V_big = I + ((1.0 - c) / (safe * safe))[..., None, None] * W + \
        ((safe - s) / (safe ** 3))[..., None, None] * WW
    t = jnp.where(small[..., None],
                  u, jnp.einsum("...ij,...j->...i", V_big, u))
    return R, t


def _badjoint(R, t):
    """Batched Ad_T for [rot, trans] ordering (reference SE3_AdjointMap)."""
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, z], -1)
    bot = jnp.concatenate([_bskew(t) @ R, R], -1)
    return jnp.concatenate([top, bot], -2)


def make_plan(n_pad: int, seps: Sequence[int]):
    """Build the static gather/scatter index plan for a (n_pad, seps)
    partition. Host-side, once per optimize() call; every array below is
    consumed by the jitted solver via plain gathers so the per-iteration
    work is all on device. seps must be sorted and end at n_pad - 1."""
    seps = [int(s) for s in seps]
    assert seps == sorted(seps) and seps[-1] == n_pad - 1
    D = len(seps)
    prev = [-1] + seps[:-1]
    max_m = max(max(s - p - 1 for p, s in zip(prev, seps)), 1)

    int_idx = np.zeros((D, max_m), np.int32)
    valid = np.zeros((D, max_m), bool)
    off_idx = np.zeros((D, max(max_m - 1, 1)), np.int32)
    ovalid = np.zeros((D, max(max_m - 1, 1)), bool)
    has_left = np.zeros(D, bool)
    left_off = np.zeros(D, np.int32)
    lsep_row = np.zeros(D, np.int32)
    uright_off = np.zeros(D, np.int32)
    ur_valid = np.zeros(D, bool)
    xl_idx = np.zeros(D, np.int32)
    sep_of = {s: i for i, s in enumerate(seps)}
    for k, (p, s) in enumerate(zip(prev, seps)):
        m = s - p - 1
        if m == 0:
            continue
        int_idx[k, max_m - m:] = np.arange(p + 1, s)
        valid[k, max_m - m:] = True
        if m > 1:
            off_idx[k, max_m - m: max_m - 1] = np.arange(p + 1, s - 1)
            ovalid[k, max_m - m: max_m - 1] = True
        if p >= 0:
            has_left[k] = True
            left_off[k] = p
            lsep_row[k] = max_m - m
            xl_idx[k] = sep_of[p]
        uright_off[k] = s - 1
        ur_valid[k] = True
    adj_mask = np.zeros(D, bool)
    adj_off = np.zeros(D, np.int32)
    for i in range(D - 1):
        if seps[i + 1] == seps[i] + 1:
            adj_mask[i] = True
            adj_off[i] = seps[i]
    return dict(seps=np.asarray(seps, np.int32), int_idx=int_idx, valid=valid,
                off_idx=off_idx, ovalid=ovalid, has_left=has_left,
                left_off=left_off, lsep_row=lsep_row, uright_off=uright_off,
                ur_valid=ur_valid, xl_idx=xl_idx, adj_mask=adj_mask,
                adj_off=adj_off, max_m=max_m, D=D, n_pad=n_pad)


def _eliminate_interior_spd(Dint, off_int, bint, Lsep, L_left, U_right, valid):
    """_eliminate_interior with Cholesky inner solves; same math — valid
    only for SPD systems (GN normal equations)."""
    off_p = jnp.concatenate([off_int, jnp.zeros((1, 6, 6), Dint.dtype)])
    I = jnp.eye(6, dtype=Dint.dtype)

    def fwd(carry, inp):
        C_prev, E_prev, d_prev = carry
        D_i, U_i, b_i, L_i, Lsep_i, v_i = inp
        Dt = jnp.where(v_i, D_i - L_i @ C_prev, I)
        rhs_b = jnp.where(v_i, b_i - (L_i @ d_prev[:, None])[:, 0],
                          jnp.zeros(6, Dint.dtype))
        rhs_E = jnp.where(v_i, Lsep_i - L_i @ E_prev,
                          jnp.zeros((6, 6), Dint.dtype))
        Lc = jnp.linalg.cholesky(Dt)
        sol = _cho_lower_solve(Lc, jnp.concatenate(
            [U_i, rhs_E, rhs_b[:, None]], axis=1))
        C_i = jnp.where(v_i, sol[:, :6], jnp.zeros((6, 6), Dint.dtype))
        E_i = sol[:, 6:12]
        d_i = sol[:, 12]
        return (C_i, E_i, d_i), (C_i, E_i, d_i, Lc)

    L = jnp.concatenate([jnp.zeros((1, 6, 6), Dint.dtype),
                         jnp.swapaxes(off_int, -1, -2)])
    init = (jnp.zeros((6, 6), Dint.dtype), jnp.zeros((6, 6), Dint.dtype),
            jnp.zeros((6,), Dint.dtype))
    _, (C, E, d, Lc) = jax.lax.scan(
        fwd, init, (Dint, off_p, bint, L, Lsep, valid))

    any_valid = jnp.any(valid)
    E_last, d_last = E[-1], d[-1]

    def bwd(carry, inp):
        F_next, G_next, g_next = carry
        C_i, E_i, d_i, v_i = inp
        F_i = jnp.where(v_i, E_i - C_i @ F_next, jnp.zeros((6, 6), Dint.dtype))
        G_i = jnp.where(v_i, -C_i @ G_next, jnp.zeros((6, 6), Dint.dtype))
        g_i = jnp.where(v_i, d_i - (C_i @ g_next[:, None])[:, 0],
                        jnp.zeros(6, Dint.dtype))
        return (F_i, G_i, g_i), (F_i, G_i, g_i)

    Ur_solved = _cho_lower_solve(Lc[-1], U_right)
    init_b = (E_last, Ur_solved, d_last)
    (_, _, _), (F, G, g) = jax.lax.scan(
        bwd, init_b, (C[:-1], E[:-1], d[:-1], valid[:-1]), reverse=True)
    F = jnp.concatenate([F, E_last[None]])
    G = jnp.concatenate([G, Ur_solved[None]])
    g = jnp.concatenate([g, d_last[None]])

    Lt = jnp.swapaxes(L_left, -1, -2)
    Ut = jnp.swapaxes(U_right, -1, -2)
    first = jnp.argmax(valid)
    F0, G0, g0 = F[first], G[first], g[first]
    Fm, Gm, gm = F[-1], G[-1], g[-1]
    z6 = jnp.zeros((6, 6), Dint.dtype)
    z1 = jnp.zeros(6, Dint.dtype)
    S_ll = jnp.where(any_valid, -Lt @ F0, z6)
    S_lr = jnp.where(any_valid, -Lt @ G0, z6)
    S_rl = jnp.where(any_valid, -Ut @ Fm, z6)
    S_rr = jnp.where(any_valid, -Ut @ Gm, z6)
    r_l = jnp.where(any_valid, -(Lt @ g0[:, None])[:, 0], z1)
    r_r = jnp.where(any_valid, -(Ut @ gm[:, None])[:, 0], z1)
    return (S_ll, S_lr, S_rl, S_rr, r_l, r_r), (F, G, g)


def _cho_lower_solve(Lc, B):
    """A^-1 B given the Cholesky factor Lc of A."""
    y = jax.scipy.linalg.solve_triangular(Lc, B, lower=True)
    return jax.scipy.linalg.solve_triangular(Lc.T, y, lower=False)


def _linearize_device(poses, pad_reg, prior_key, prior_meas, prior_sqrtI,
                      prior_valid, bt_from, bt_to, bt_meas, bt_sqrtI,
                      bt_valid, chain_slot, loop_bt, loop_swap, loop_valid):
    """Batched linearization of prior + between factors into the
    block-tridiagonal(+loop) normal equations (the device analog of
    PoseGraphOptimizer._build_linear_system; reference buildLinearSystem,
    PoseGraphOptimizer.cpp:392-461)."""
    n_pad = poses.shape[0]
    dt = poses.dtype

    diag = jnp.zeros((n_pad, 6, 6), dt)
    b = jnp.zeros((n_pad, 6), dt)
    diag = diag + jnp.eye(6, dtype=dt) * pad_reg[:, None, None]

    # priors: J = I  (prior_error)
    Tp = poses[prior_key]
    Rp, tp = Tp[:, :3, :3], Tp[:, :3, 3]
    Rm, tm = prior_meas[:, :3, :3], prior_meas[:, :3, 3]
    err_p = _bse3_log(jnp.swapaxes(Rm, -1, -2) @ Rp,
                      jnp.einsum("...ji,...j->...i", Rm, tp - tm))
    info_p = jnp.swapaxes(prior_sqrtI, -1, -2) @ prior_sqrtI
    vm = prior_valid[:, None, None].astype(dt)
    diag = diag.at[prior_key].add(info_p * vm)
    b = b.at[prior_key].add(-jnp.einsum("...ij,...j->...i", info_p, err_p)
                            * prior_valid[:, None].astype(dt))

    # betweens (between_error: J_to = I, J_from = -Ad(hx^-1))
    Tf, Tt = poses[bt_from], poses[bt_to]
    R_f, t_f = Tf[:, :3, :3], Tf[:, :3, 3]
    R_t, t_t = Tt[:, :3, :3], Tt[:, :3, 3]
    R_m, t_m = bt_meas[:, :3, :3], bt_meas[:, :3, 3]
    R_hx = jnp.swapaxes(R_f, -1, -2) @ R_t
    t_hx = jnp.einsum("...ji,...j->...i", R_f, t_t - t_f)
    R_err = jnp.swapaxes(R_m, -1, -2) @ R_hx
    t_err = jnp.einsum("...ji,...j->...i", R_m, t_hx - t_m)
    err = _bse3_log(R_err, t_err)
    R_hx_inv = jnp.swapaxes(R_hx, -1, -2)
    t_hx_inv = -jnp.einsum("...ij,...j->...i", R_hx_inv, t_hx)
    J_from = -_badjoint(R_hx_inv, t_hx_inv)
    Jw_f = bt_sqrtI @ J_from
    Jw_t = bt_sqrtI  # J_to = I
    ew = jnp.einsum("...ij,...j->...i", bt_sqrtI, err)
    bv = bt_valid.astype(dt)
    blk_ff = jnp.swapaxes(Jw_f, -1, -2) @ Jw_f * bv[:, None, None]
    blk_tt = jnp.swapaxes(Jw_t, -1, -2) @ Jw_t * bv[:, None, None]
    Hij = jnp.swapaxes(Jw_f, -1, -2) @ Jw_t  # coupling (from, to)
    rhs_f = -jnp.einsum("...ji,...j->...i", Jw_f, ew) * bv[:, None]
    rhs_t = -jnp.einsum("...ji,...j->...i", Jw_t, ew) * bv[:, None]
    diag = diag.at[bt_from].add(blk_ff)
    diag = diag.at[bt_to].add(blk_tt)
    b = b.at[bt_from].add(rhs_f)
    b = b.at[bt_to].add(rhs_t)

    # chain couplings: scatter Hij_lo at row lo; non-chain/invalid
    # factors are routed to dump row n_pad-1 and sliced off.
    lo_is_from = bt_from < bt_to
    Hij_lo = jnp.where(lo_is_from[:, None, None], Hij,
                       jnp.swapaxes(Hij, -1, -2))
    off_acc = jnp.zeros((n_pad, 6, 6), dt)
    off_acc = off_acc.at[chain_slot].add(Hij_lo * bv[:, None, None])
    off = off_acc[: n_pad - 1]

    # loop couplings (lo, hi): gather per loop edge
    lb = Hij_lo[loop_bt] * loop_valid[:, None, None].astype(dt)
    return diag, off, b, lb


@partial(jax.jit, static_argnames=("max_m", "D", "n_pad", "max_iters"))
def _gn_device(poses, real_mask, pad_reg,
               prior_key, prior_meas, prior_sqrtI, prior_valid,
               bt_from, bt_to, bt_meas, bt_sqrtI, bt_valid, chain_slot,
               loop_bt, loop_a, loop_b, loop_swap, loop_valid,
               seps, int_idx, valid, off_idx, ovalid, has_left, left_off,
               lsep_row, uright_off, ur_valid, xl_idx, adj_mask, adj_off,
               max_m: int, D: int, n_pad: int,
               max_iters: int, tol: float):
    """Full GN pose-graph optimization as one device program: ≤max_iters
    iterations of linearize -> partitioned Schur solve -> retract, with
    convergence on ‖dx‖ < tol (reference optimize,
    PoseGraphOptimizer.cpp:326-390)."""
    dt = poses.dtype
    I6 = jnp.eye(6, dtype=dt)

    def solve_once(poses):
        diag, off, b, lb = _linearize_device(
            poses, pad_reg, prior_key, prior_meas, prior_sqrtI, prior_valid,
            bt_from, bt_to, bt_meas, bt_sqrtI, bt_valid, chain_slot,
            loop_bt, loop_swap, loop_valid)

        # ---- pack interiors via plan gathers ----
        Dint = jnp.where(valid[..., None, None], diag[int_idx], I6)
        Oint = (jnp.where(ovalid[..., None, None], off[off_idx], 0.0)
                if max_m > 1 else jnp.zeros((D, 0, 6, 6), dt))
        Bint = jnp.where(valid[..., None], b[int_idx], 0.0)
        Lleft = jnp.where(has_left[:, None, None],
                          jnp.swapaxes(off[left_off], -1, -2), 0.0)
        onehot = jax.nn.one_hot(lsep_row, max_m, dtype=dt)
        Lsep = onehot[..., None, None] * Lleft[:, None]
        Uright = jnp.where(ur_valid[:, None, None], off[uright_off], 0.0)

        (S_ll, S_lr, S_rl, S_rr, r_l, r_r), (F, G, g) = jax.vmap(
            _eliminate_interior_spd)(Dint, Oint, Bint, Lsep, Lleft, Uright,
                                     valid)

        # ---- reduced separator system on device ----
        idx = jnp.arange(D)
        km1 = jnp.clip(idx - 1, 0)
        kp1 = jnp.clip(idx + 1, 0, D - 1)
        lmask = (idx > 0).astype(dt)[:, None, None]
        Hs4 = jnp.zeros((D, 6, D, 6), dt)
        Hs4 = Hs4.at[idx, :, idx, :].add(diag[seps] + S_rr)
        Hs4 = Hs4.at[km1, :, km1, :].add(S_ll * lmask)
        Hs4 = Hs4.at[km1, :, idx, :].add(S_lr * lmask)
        Hs4 = Hs4.at[idx, :, km1, :].add(S_rl * lmask)
        amask = adj_mask.astype(dt)[:, None, None]
        adj_blk = off[adj_off] * amask
        Hs4 = Hs4.at[idx, :, kp1, :].add(adj_blk)
        Hs4 = Hs4.at[kp1, :, idx, :].add(jnp.swapaxes(adj_blk, -1, -2))
        lvm = loop_valid.astype(dt)[:, None, None]
        Hs4 = Hs4.at[loop_a, :, loop_b, :].add(lb * lvm)
        Hs4 = Hs4.at[loop_b, :, loop_a, :].add(
            jnp.swapaxes(lb, -1, -2) * lvm)
        bs = b[seps] + r_r
        bs = bs.at[km1].add(r_l * (idx > 0).astype(dt)[:, None])
        Hs = Hs4.reshape(D * 6, D * 6)
        Lc = jnp.linalg.cholesky(Hs)
        xs = _cho_lower_solve(Lc, bs.reshape(-1)[:, None])[:, 0].reshape(D, 6)

        # ---- back-substitution ----
        xl = jnp.where(has_left[:, None], xs[xl_idx], 0.0)
        xi = g - jnp.einsum("kmij,kj->kmi", F, xl) \
            - jnp.einsum("kmij,kj->kmi", G, xs)
        x = jnp.zeros((n_pad + 1, 6), dt)
        scatter_idx = jnp.where(valid, int_idx, n_pad)
        x = x.at[scatter_idx].add(jnp.where(valid[..., None], xi, 0.0))
        x = x.at[seps].add(xs)
        return x[:n_pad] * real_mask[:, None]

    def retract(poses, dx):
        dR, dtr = _bse3_exp(dx)
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        R_new = R @ dR
        t_new = jnp.einsum("...ij,...j->...i", R, dtr) + t
        out = jnp.tile(jnp.eye(4, dtype=dt), (poses.shape[0], 1, 1))
        out = out.at[:, :3, :3].set(R_new)
        out = out.at[:, :3, 3].set(t_new)
        return out

    def cond(carry):
        poses, it, dxn, ok = carry
        return (it < max_iters) & (dxn >= tol) & ok

    def body(carry):
        poses, it, _, _ = carry
        dx = solve_once(poses)
        dxn = jnp.linalg.norm(dx)
        ok = jnp.all(jnp.isfinite(dx))
        poses = jnp.where(ok, retract(poses, dx), poses)
        return poses, it + 1, dxn, ok

    poses, iters, dxn, ok = jax.lax.while_loop(
        cond, body, (poses, jnp.int32(0), jnp.asarray(jnp.inf, dt),
                     jnp.bool_(True)))
    converged = ok & (dxn < tol)
    return poses, converged, iters


def _pow2(x: int, lo: int = 1) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def gn_optimize_device(poses: np.ndarray, priors, betweens,
                       n_blocks: int = 8, max_iters: int = 10,
                       tol: float = 1e-6):
    """Host wrapper: factor lists -> padded arrays + partition plan, one
    jitted f64 GN solve on device, poses back. `priors` is a list of
    (key, measured(4,4), sqrt_info(6,6)); `betweens` of (key_from,
    key_to, measured, sqrt_info). Returns (poses_new (n,4,4) f64, ok).

    Shapes are padded to powers of two (with identity-prior padding
    poses chained past the last real separator) so recompiles are
    O(log n) over a trajectory's lifetime."""
    enable_x64 = jax.enable_x64  # thread-local x64 context (jax >= 0.9)

    n = len(poses)
    if n == 0:
        return poses, True
    loop_edges = []
    for k, (i, j, _, _) in enumerate(betweens):
        lo, hi = (i, j) if i < j else (j, i)
        if hi != lo + 1:
            loop_edges.append((lo, hi))
    seps_real = plan_partition(n, min(n_blocks, max(n // 2, 1)), loop_edges)

    n_pad = _pow2(n, 8)
    seps = sorted(set(seps_real + [n_pad - 1]))
    plan = make_plan(n_pad, seps)
    sep_of = {s: i for i, s in enumerate(seps)}

    P = _pow2(max(len(priors), 1))
    M = _pow2(max(len(betweens), 1))
    L = _pow2(max(len(loop_edges), 1))

    prior_key = np.zeros(P, np.int32)
    prior_meas = np.tile(np.eye(4), (P, 1, 1))
    prior_sqrtI = np.zeros((P, 6, 6))
    prior_valid = np.zeros(P, bool)
    for k, (key, meas, sqI) in enumerate(priors):
        prior_key[k] = key
        prior_meas[k] = meas
        prior_sqrtI[k] = sqI
        prior_valid[k] = True

    bt_from = np.zeros(M, np.int32)
    bt_to = np.zeros(M, np.int32)
    bt_meas = np.tile(np.eye(4), (M, 1, 1))
    bt_sqrtI = np.zeros((M, 6, 6))
    bt_valid = np.zeros(M, bool)
    chain_slot = np.full(M, n_pad - 1, np.int32)  # dump row by default
    loop_bt = np.zeros(L, np.int32)
    loop_a = np.zeros(L, np.int32)
    loop_b = np.zeros(L, np.int32)
    loop_swap = np.zeros(L, bool)
    loop_valid = np.zeros(L, bool)
    li = 0
    for k, (i, j, meas, sqI) in enumerate(betweens):
        bt_from[k] = i
        bt_to[k] = j
        bt_meas[k] = meas
        bt_sqrtI[k] = sqI
        bt_valid[k] = True
        lo, hi = (i, j) if i < j else (j, i)
        if hi == lo + 1:
            chain_slot[k] = lo
        else:
            loop_bt[li] = k
            loop_a[li] = sep_of[lo]
            loop_b[li] = sep_of[hi]
            loop_swap[li] = i > j
            loop_valid[li] = True
            li += 1

    poses_pad = np.tile(np.eye(4), (n_pad, 1, 1))
    poses_pad[:n] = poses
    real_mask = np.zeros(n_pad)
    real_mask[:n] = 1.0
    pad_reg = np.zeros(n_pad)
    pad_reg[n:] = 1.0

    with enable_x64():
        out, converged, iters = _gn_device(
            jnp.asarray(poses_pad, jnp.float64),
            jnp.asarray(real_mask, jnp.float64),
            jnp.asarray(pad_reg, jnp.float64),
            jnp.asarray(prior_key), jnp.asarray(prior_meas, jnp.float64),
            jnp.asarray(prior_sqrtI, jnp.float64), jnp.asarray(prior_valid),
            jnp.asarray(bt_from), jnp.asarray(bt_to),
            jnp.asarray(bt_meas, jnp.float64),
            jnp.asarray(bt_sqrtI, jnp.float64), jnp.asarray(bt_valid),
            jnp.asarray(chain_slot),
            jnp.asarray(loop_bt), jnp.asarray(loop_a), jnp.asarray(loop_b),
            jnp.asarray(loop_swap), jnp.asarray(loop_valid),
            jnp.asarray(plan["seps"]), jnp.asarray(plan["int_idx"]),
            jnp.asarray(plan["valid"]), jnp.asarray(plan["off_idx"]),
            jnp.asarray(plan["ovalid"]), jnp.asarray(plan["has_left"]),
            jnp.asarray(plan["left_off"]), jnp.asarray(plan["lsep_row"]),
            jnp.asarray(plan["uright_off"]), jnp.asarray(plan["ur_valid"]),
            jnp.asarray(plan["xl_idx"]), jnp.asarray(plan["adj_mask"]),
            jnp.asarray(plan["adj_off"]),
            max_m=plan["max_m"], D=plan["D"], n_pad=n_pad,
            max_iters=max_iters, tol=tol)
        out_np = np.asarray(out[:n], np.float64)
        ok = bool(converged)
    if not np.all(np.isfinite(out_np)):
        return poses, False
    return out_np, ok
