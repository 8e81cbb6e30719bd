"""Loop detection + pose-graph closure for the SfM/SLAM pipelines
(BASELINE config 3 "pose-graph loop closure"; SURVEY.md §7 stage 7).

Loop detection is the all-pairs covisibility GEMM from the distributed
layer (``parallel/all_pairs.py`` — sharded over a mesh when one is given):
frame-descriptor sets score against each other, candidates are
high-scoring non-adjacent pairs.  Each candidate is geometrically verified
by two-view RANSAC; verified loops become pose-graph edges whose relative
pose comes from essential-matrix decomposition, with the translation scale
borrowed from the current trajectory (monocular scale is unobservable from
one pair).  The chain + loop edges are optimized by ``ba/pose_graph`` and
the corrected poses written back into the SfM state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from points_matching.ba.pose_graph import PoseGraph, optimize_pose_graph
from points_matching.core.config import SfMConfig
from points_matching.core.types import CameraIntrinsics, Descriptors, Pose
from points_matching.geometry.fundamental import essential_from_fundamental
from points_matching.geometry.pose import recover_pose
from points_matching.geometry.ransac import ransac_fundamental
from points_matching.ops.matching import match_descriptors
from points_matching.parallel.all_pairs import all_pairs_scores


@dataclasses.dataclass
class LoopCandidate:
    i: int
    j: int                      # j < i - min_gap
    score: int                  # covisibility match count
    verified: bool = False
    num_inliers: int = 0


def detect_loop_candidates(
    desc: Array,                 # [N, K, D] per-frame descriptors
    mask: Array,                 # [N, K]
    min_gap: int = 5,
    min_score: int = 30,
    max_candidates: int = 5,
    mesh=None,
    ratio: float = 0.8,
) -> List[LoopCandidate]:
    """Covisibility-based loop candidates: high match-count pairs at least
    ``min_gap`` frames apart (per query frame, best partner only)."""
    scores = np.array(all_pairs_scores(desc, mask, mesh=mesh, ratio=ratio))
    n = scores.shape[0]
    cands: List[LoopCandidate] = []
    for i in range(n):
        js = np.arange(n)
        far = js <= i - min_gap
        if not far.any():
            continue
        row = np.where(far, scores[i], -1)
        j = int(row.argmax())
        if row[j] >= min_score:
            cands.append(LoopCandidate(i=i, j=j, score=int(row[j])))
    cands.sort(key=lambda c: -c.score)
    return cands[:max_candidates]


def _verify_loop_traced(
    kps_i: Array, desc_i: Array, mask_i: Array,
    kps_j: Array, desc_j: Array, mask_j: Array,
    K: CameraIntrinsics,
    config: SfMConfig,
    key: Array,
    min_inliers: int,
) -> Tuple[Array, Pose, Array]:
    """Device-resident geometric verification of ONE candidate: two-view
    RANSAC F → E → (R, t̂).  Fully traced (no host syncs) so candidates
    batch under vmap — the per-candidate ``float()``/``int()`` transfers
    this replaces were a scaling bug at large candidate counts.
    Returns (ok bool, pose_i←j with unit/zero translation, inliers)."""
    m = match_descriptors(
        Descriptors(data=desc_j, mask=mask_j),
        Descriptors(data=desc_i, mask=mask_i),
        config.two_view.matcher,
    )
    n = kps_j.shape[0]
    pj = jnp.take(kps_j, jnp.clip(m.query_idx, 0, n - 1), axis=0)
    pi = jnp.take(kps_i, jnp.clip(m.train_idx, 0, n - 1), axis=0)
    est = ransac_fundamental(key, pj, pi, m.mask, config.two_view.ransac)
    E = essential_from_fundamental(est.F, K.matrix(), K.matrix())
    w = jnp.logical_and(m.mask, est.inlier_mask)
    pjn = K.normalize_points(pj)
    pin = K.normalize_points(pi)
    pose, _, cheir = recover_pose(E, pjn, pin, w)

    # Parallax gate: for a true revisit (near-zero baseline) the essential
    # translation direction is numerically meaningless — the inlier rays
    # barely move.  Median angular ray motion below ~0.6° ⇒ constrain the
    # loop edge to t = 0 instead of a garbage direction.
    rays_j = jnp.concatenate([pjn, jnp.ones_like(pjn[..., :1])], -1)
    rays_i = jnp.concatenate([pin, jnp.ones_like(pin[..., :1])], -1)
    rj = rays_j / jnp.linalg.norm(rays_j, axis=-1, keepdims=True)
    ri_rot = jnp.einsum("ij,nj->ni", pose.R, rj)  # frame-j rays in frame i
    ri = rays_i / jnp.linalg.norm(rays_i, axis=-1, keepdims=True)
    cosang = jnp.clip(jnp.sum(ri * ri_rot, axis=-1), -1.0, 1.0)
    ang = jnp.where(w, jnp.arccos(cosang), jnp.inf)
    k = jnp.maximum(jnp.sum(w.astype(jnp.int32)) // 2, 0)
    low_parallax = jnp.sort(ang)[k] < 0.01

    t = jnp.where(low_parallax, jnp.zeros_like(pose.t), pose.t)
    cheir_ok = jnp.sum(cheir.astype(jnp.int32)) >= min_inliers // 2
    ok = jnp.logical_and(
        est.num_inliers >= min_inliers,
        jnp.logical_or(low_parallax, cheir_ok),
    )
    return ok, Pose(R=pose.R, t=t), est.num_inliers


@functools.partial(jax.jit, static_argnames=("config", "min_inliers"))
def _verify_loops_batched(
    kps_i, desc_i, mask_i, kps_j, desc_j, mask_j, K, keys, config,
    min_inliers,
):
    """vmap of ``_verify_loop_traced`` over the candidate axis — ONE device
    round-trip for the whole candidate set."""
    fn = lambda a, b, c, d, e, f, k: _verify_loop_traced(
        a, b, c, d, e, f, K, config, k, min_inliers)
    return jax.vmap(fn)(kps_i, desc_i, mask_i, kps_j, desc_j, mask_j, keys)


def verify_loop(
    kps_i: Array, desc_i: Array, mask_i: Array,
    kps_j: Array, desc_j: Array, mask_j: Array,
    K: CameraIntrinsics,
    config: SfMConfig,
    key: Array,
    min_inliers: int = 30,
) -> Tuple[bool, Optional[Pose], int]:
    """Single-candidate convenience wrapper (one host transfer at the end)."""
    ok, pose, ninl = _verify_loop_traced(
        kps_i, desc_i, mask_i, kps_j, desc_j, mask_j, K, config, key,
        min_inliers,
    )
    ok_h, R_h, t_h, ninl_h = jax.device_get((ok, pose.R, pose.t, ninl))
    if not bool(ok_h):
        return False, None, int(ninl_h)
    return True, Pose(R=jnp.asarray(R_h), t=jnp.asarray(t_h)), int(ninl_h)


def close_loops(
    poses: Pose,                 # [C] current world→camera estimates
    num_cams: int,
    frames: Sequence[Tuple[Array, Array, Array]],  # (kps_xy, desc, mask)
    K: CameraIntrinsics,
    config: SfMConfig,
    seed: int = 0,
    min_gap: int = 5,
    min_score: int = 30,
    loop_weight: float = 10.0,
    mesh=None,
) -> Tuple[Pose, List[LoopCandidate]]:
    """Detect, verify and close loops over a registered trajectory.

    Returns (corrected poses, the candidate list with verification flags).
    Odometry edges come from the current estimates (weight 1); verified
    loop edges get ``loop_weight``.  Monocular translation scale for each
    loop edge is set to the current-estimate baseline of that pair.
    """
    C = num_cams
    desc = jnp.stack([f[1] for f in frames[:C]])
    mask = jnp.stack([f[2] for f in frames[:C]])
    cands = detect_loop_candidates(
        desc, mask, min_gap=min_gap, min_score=min_score, mesh=mesh,
        ratio=config.two_view.matcher.ratio,
    )
    if not cands:
        return poses, cands

    # Batched device-resident verification: stack the candidate frames,
    # vmap the whole set through one jit region, sync ONCE.
    ci = np.asarray([c.i for c in cands])
    cj = np.asarray([c.j for c in cands])
    kps = jnp.stack([f[0] for f in frames[:C]])
    kps_i, desc_i, mask_i = kps[ci], desc[ci], mask[ci]
    kps_j, desc_j, mask_j = kps[cj], desc[cj], mask[cj]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(cands))
    ok_b, rel_b, ninl_b = _verify_loops_batched(
        kps_i, desc_i, mask_i, kps_j, desc_j, mask_j, K, keys, config,
        30,
    )
    ok_h, R_h, t_h, ninl_h = jax.device_get(
        (ok_b, rel_b.R, rel_b.t, ninl_b))

    verified: List[Tuple[LoopCandidate, Pose]] = []
    for n_c, c in enumerate(cands):
        c.verified = bool(ok_h[n_c])
        c.num_inliers = int(ninl_h[n_c])
        if c.verified:
            verified.append(
                (c, Pose(R=jnp.asarray(R_h[n_c]), t=jnp.asarray(t_h[n_c]))))

    if not verified:
        return poses, cands

    # Odometry chain from current estimates.
    idx = jnp.arange(C - 1)
    Ti = jax.tree.map(lambda a: a[idx], poses)
    Tj = jax.tree.map(lambda a: a[idx + 1], poses)
    Z_odom = Ti.compose(Tj.inverse())
    ei = [int(v) for v in range(C - 1)]
    ej = [int(v) + 1 for v in range(C - 1)]
    w = [1.0] * (C - 1)

    ZR = [np.asarray(Z_odom.R)]
    Zt = [np.asarray(Z_odom.t)]
    for c, rel in verified:
        # rel: cam_j → cam_i with |t| = 1 (or exactly 0 for a low-parallax
        # revisit); borrow the translation scale from the current estimate
        Pi = jax.tree.map(lambda a: a[c.i], poses)
        Pj = jax.tree.map(lambda a: a[c.j], poses)
        est_rel = Pi.compose(Pj.inverse())
        t_dir = np.asarray(rel.t)
        scale = float(jnp.linalg.norm(est_rel.t)) if np.linalg.norm(t_dir) > 0.5 else 0.0
        ZR.append(np.asarray(rel.R)[None])
        Zt.append((t_dir * scale)[None])
        ei.append(c.i)
        ej.append(c.j)
        w.append(loop_weight)

    Z = Pose(
        R=jnp.asarray(np.concatenate(ZR, axis=0), jnp.float32),
        t=jnp.asarray(np.concatenate(Zt, axis=0), jnp.float32),
    )
    E = len(ei)
    g = PoseGraph(
        poses=jax.tree.map(lambda a: a[:C], poses),
        edges_i=jnp.asarray(ei, jnp.int32),
        edges_j=jnp.asarray(ej, jnp.int32),
        Z=Z,
        weight=jnp.asarray(w, jnp.float32),
        mask=jnp.ones((E,), bool),
        fixed=jnp.arange(C) == 0,
    )
    g_opt, _ = optimize_pose_graph(g)

    # write corrected poses back into the fixed-capacity pose array
    full_R = poses.R.at[:C].set(g_opt.poses.R)
    full_t = poses.t.at[:C].set(g_opt.poses.t)
    return Pose(R=full_R, t=full_t), cands
