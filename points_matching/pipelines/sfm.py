"""Incremental SfM / SLAM on one host (SURVEY.md §7 stage 7; BASELINE
config 3: "100-frame sequence — incremental registration, local BA,
pose-graph loop closure on one host").

Architecture (SURVEY.md §3.2 ``sfm_incremental`` and the §7 "host loop vs
device loop" hard part): the map lives on device in fixed-capacity arrays
(static shapes + masks); each per-frame step — landmark matching (GEMM),
RANSAC PnP registration, observation append, two-view triangulation of new
landmarks — is ONE jitted function; the host loop only sequences frames and
decides when to run the (also jitted) local-BA window.  Host↔device traffic
per frame is keypoints + descriptors in, a pose + scalar stats out.

The reference has none of this (it stops at one F matrix); the design goes
straight to the BASELINE north-star capabilities.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from points_matching.core import struct
from jax import Array

from points_matching.ba.lm import bundle_adjust, grid_from_obs, make_ba_state
from points_matching.ba.sparse import bundle_adjust_sparse, make_sparse_ba_state
from points_matching.core.config import BAConfig, MatcherConfig, RansacConfig, SfMConfig
from points_matching.core.types import (
    CameraIntrinsics,
    Descriptors,
    Keypoints,
    Pose,
)
from points_matching.geometry.pnp import ransac_pnp
from points_matching.geometry.fundamental import essential_from_fundamental
from points_matching.geometry.pose import recover_pose
from points_matching.geometry.ransac import ransac_fundamental
from points_matching.geometry.triangulate import triangulate_dlt
from points_matching.ops.matching import match_descriptors


@struct.dataclass
class SfMState:
    """Device-resident incremental-SfM map (all capacities static).

    Attributes:
      poses:    Pose [C] world→camera per registered frame.
      cam_mask: [C] bool — registered frames.
      X:        [L, 3] landmark positions.
      lm_mask:  [L] bool.
      lm_desc:  [L, D] last-seen descriptor per landmark (for 2D↔3D match).
      obs_cam/obs_lm/obs_uv/obs_mask: [O]-capacity observation list.
      prev_kps_xy / prev_desc / prev_mask: previous frame's features (for
        triangulating new landmarks against).
      num_cams / num_lms / num_obs: scalar int32 write cursors.
    """

    poses: Pose
    cam_mask: Array
    X: Array
    lm_mask: Array
    lm_desc: Array
    obs_cam: Array
    obs_lm: Array
    obs_uv: Array
    obs_mask: Array
    prev_kps_xy: Array
    prev_desc: Array
    prev_mask: Array
    prev_lm: Array          # [N] int32 — landmark slot each previous-frame
                            # keypoint observes, or -1 (track association)
    num_cams: Array
    num_lms: Array
    num_obs: Array


def init_sfm_state(config: SfMConfig, num_features: int, desc_dim: int) -> SfMState:
    C, L, O = config.max_cameras, config.max_landmarks, config.max_observations
    return SfMState(
        poses=Pose.identity((C,)),
        cam_mask=jnp.zeros((C,), bool),
        X=jnp.zeros((L, 3), jnp.float32),
        lm_mask=jnp.zeros((L,), bool),
        lm_desc=jnp.zeros((L, desc_dim), jnp.float32),
        obs_cam=jnp.zeros((O,), jnp.int32),
        obs_lm=jnp.zeros((O,), jnp.int32),
        obs_uv=jnp.zeros((O, 2), jnp.float32),
        obs_mask=jnp.zeros((O,), bool),
        prev_kps_xy=jnp.zeros((num_features, 2), jnp.float32),
        prev_desc=jnp.zeros((num_features, desc_dim), jnp.float32),
        prev_mask=jnp.zeros((num_features,), bool),
        prev_lm=jnp.full((num_features,), -1, jnp.int32),
        num_cams=jnp.asarray(0, jnp.int32),
        num_lms=jnp.asarray(0, jnp.int32),
        num_obs=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# Fixed-capacity append helpers (scatter with drop-on-overflow)
# ---------------------------------------------------------------------------

def _append_positions(capacity: int, cursor: Array, rows_mask: Array) -> Array:
    """Target slot per input row: cursor + rank among valid rows.

    Invalid/overflowing rows get ``capacity`` — out of range on purpose, so
    every scatter can write UNCONDITIONALLY with ``mode="drop"``.  (Routing
    rejects to a real slot like 0 is a correctness trap: XLA scatter order
    for duplicate indices is undefined, so a reject could clobber a valid
    write landing on the same slot.)
    """
    rank = jnp.cumsum(rows_mask.astype(jnp.int32)) - 1
    pos = cursor + rank
    ok = jnp.logical_and(rows_mask, pos < capacity)
    return jnp.where(ok, pos, capacity)


# ---------------------------------------------------------------------------
# Jitted SfM steps
# ---------------------------------------------------------------------------

class StepStats(NamedTuple):
    registered: Array       # bool — frame accepted
    num_pnp_inliers: Array
    num_new_landmarks: Array
    pose: Pose


@functools.partial(jax.jit, static_argnames=("config",))
def bootstrap_two_view(
    state: SfMState,
    kps1_xy: Array, desc1: Array, mask1: Array,
    kps2_xy: Array, desc2: Array, mask2: Array,
    K: CameraIntrinsics,
    key: Array,
    config: SfMConfig,
) -> Tuple[SfMState, StepStats]:
    """Initialize the map from the first two frames: match → RANSAC F → E →
    pose recovery (cheirality) → triangulation (BASELINE config 2 inside)."""
    tv = config.two_view
    matches = match_descriptors(
        Descriptors(data=desc1, mask=mask1),
        Descriptors(data=desc2, mask=mask2),
        tv.matcher,
    )
    n1 = kps1_xy.shape[0]
    p1 = jnp.take(kps1_xy, jnp.clip(matches.query_idx, 0, n1 - 1), axis=0)
    p2 = jnp.take(kps2_xy, jnp.clip(matches.train_idx, 0, n1 - 1), axis=0)
    p1n = K.normalize_points(p1)
    p2n = K.normalize_points(p2)

    # Multiple independent RANSAC candidates, selected by CHEIRALITY-
    # consistent landmark count, not epipolar inlier count: a low-parallax
    # pair can yield an F with many epipolar inliers whose recovered pose
    # still puts a large fraction of points behind a camera — one such
    # bootstrap poisons the whole map (every later PnP fails).  All
    # candidates solve/score batched under vmap; no sequential retries.
    def candidate(k):
        est = ransac_fundamental(k, p1, p2, matches.mask, tv.ransac)
        E = essential_from_fundamental(est.F, K.matrix(), K.matrix())
        w = jnp.logical_and(matches.mask, est.inlier_mask)
        pose2, X_cam1, cheir = recover_pose(E, p1n, p2n, w)
        good = jnp.logical_and(w, cheir)
        z = X_cam1[..., 2]
        # depth sanity: drop points behind/too far (dimensionless |t|=1)
        good = jnp.logical_and(good, jnp.logical_and(z > 0.05, z < 100.0))
        return est, pose2, X_cam1, good

    keys = jax.random.split(key, config.bootstrap_candidates)
    cands = jax.vmap(candidate)(keys)
    b = jnp.argmax(jnp.sum(cands[3].astype(jnp.int32), axis=-1))
    est, pose2, X_cam1, good = jax.tree.map(lambda a: a[b], cands)

    # landmarks (world frame = cam-1 frame)
    d_new = jnp.take(desc1, jnp.clip(matches.query_idx, 0, n1 - 1), axis=0)
    L_cap = state.X.shape[0]
    safe = _append_positions(L_cap, state.num_lms, good)  # rejects → L_cap (dropped)
    ok = safe < L_cap
    X_new = state.X.at[safe].set(X_cam1, mode="drop")
    lm_mask_new = state.lm_mask.at[safe].set(True, mode="drop")
    lm_desc_new = state.lm_desc.at[safe].set(d_new, mode="drop")
    num_lms = jnp.minimum(
        state.num_lms + jnp.sum(good.astype(jnp.int32)), state.X.shape[0]
    ).astype(jnp.int32)

    # observations: cam 0 sees (p1), cam 1 sees (p2)
    def add_obs(state_obs, cam_idx, uv):
        obs_cam, obs_lm, obs_uv, obs_mask, cursor = state_obs
        sp = _append_positions(obs_cam.shape[0], cursor, ok)
        obs_cam = obs_cam.at[sp].set(cam_idx, mode="drop")
        obs_lm = obs_lm.at[sp].set(safe, mode="drop")
        obs_uv = obs_uv.at[sp].set(uv, mode="drop")
        obs_mask = obs_mask.at[sp].set(True, mode="drop")
        cursor = jnp.minimum(cursor + jnp.sum(ok.astype(jnp.int32)),
                             obs_cam.shape[0]).astype(jnp.int32)
        return (obs_cam, obs_lm, obs_uv, obs_mask, cursor)

    obs = (state.obs_cam, state.obs_lm, state.obs_uv, state.obs_mask, state.num_obs)
    obs = add_obs(obs, 0, p1)
    obs = add_obs(obs, 1, p2)

    poses = jax.tree.map(
        lambda a, b: a.at[1].set(b), state.poses,
        jax.tree.map(lambda x: x, pose2),
    )
    cam_mask = state.cam_mask.at[0].set(True).at[1].set(True)

    # track association for frame 2's keypoints: train index → landmark slot
    n2 = kps2_xy.shape[0]
    t_idx = jnp.clip(matches.train_idx, 0, n2 - 1)
    prev_lm = jnp.full((n2,), -1, jnp.int32).at[
        jnp.where(ok, t_idx, n2)
    ].set(jnp.where(ok, safe, -1).astype(jnp.int32), mode="drop")

    new_state = state.replace(
        poses=poses,
        cam_mask=cam_mask,
        X=X_new, lm_mask=lm_mask_new, lm_desc=lm_desc_new,
        obs_cam=obs[0], obs_lm=obs[1], obs_uv=obs[2], obs_mask=obs[3],
        num_obs=obs[4],
        num_lms=num_lms,
        prev_kps_xy=kps2_xy, prev_desc=desc2, prev_mask=mask2,
        prev_lm=prev_lm,
        num_cams=jnp.asarray(2, jnp.int32),
    )
    n_new = jnp.sum(good.astype(jnp.int32))
    stats = StepStats(
        registered=n_new >= config.keyframe_min_inliers,
        num_pnp_inliers=est.num_inliers,
        num_new_landmarks=n_new,
        pose=pose2,
    )
    return new_state, stats


@functools.partial(jax.jit, static_argnames=("config",))
def register_frame(
    state: SfMState,
    kps_xy: Array, desc: Array, fmask: Array,
    K: CameraIntrinsics,
    key: Array,
    config: SfMConfig,
) -> Tuple[SfMState, StepStats]:
    """Register one new frame against the map:

    1. 2D↔3D: frame descriptors vs landmark descriptors (masked GEMM + ratio)
    2. RANSAC PnP (normalized coords) + GN refinement → pose
    3. append observations for PnP inliers; refresh landmark descriptors
    4. new landmarks: frame↔previous-frame matches not yet in the map,
       triangulated from the two registered poses
    """
    cam_idx = state.num_cams
    k_pnp, k_f = jax.random.split(key)
    L = state.X.shape[0]
    n = kps_xy.shape[0]

    # -- 1a. TRACKS: 2D↔2D match to the previous frame, then look up which
    # landmark each previous keypoint observes (prev_lm).  This is the
    # primary association — frame-to-frame matching is far more precise
    # than matching into a landmark bank full of near-duplicates.
    m2d = match_descriptors(
        Descriptors(data=desc, mask=fmask),
        Descriptors(data=state.prev_desc, mask=state.prev_mask),
        config.two_view.matcher,
    )
    q2 = jnp.clip(m2d.query_idx, 0, n - 1)
    p2_ = jnp.clip(m2d.train_idx, 0, n - 1)
    track_lm = jnp.where(m2d.mask, jnp.take(state.prev_lm, p2_), -1)
    tracked = track_lm >= 0

    # -- 1b. BANK: descriptor match into the landmark bank (threshold +
    # cross-check — see SfMConfig.map_matcher) for re-localization and
    # track re-acquisition.
    m3d = match_descriptors(
        Descriptors(data=desc, mask=fmask),
        Descriptors(data=state.lm_desc, mask=state.lm_mask),
        config.map_matcher,
    )

    # -- 2. PnP on the union of track + bank correspondences ---------------
    corr_q = jnp.concatenate([q2, jnp.clip(m3d.query_idx, 0, n - 1)])
    corr_l = jnp.concatenate([
        jnp.clip(track_lm, 0, L - 1), jnp.clip(m3d.train_idx, 0, L - 1)
    ])
    corr_m = jnp.concatenate([tracked, m3d.mask])
    X3d = jnp.take(state.X, corr_l, axis=0)
    uv = jnp.take(kps_xy, corr_q, axis=0)
    uvn = K.normalize_points(uv)

    # Bias minimal-set sampling toward track rows: bank matches hit
    # near-duplicate landmarks whose fresh (2-observation) positions are
    # noisy, so the union's inlier fraction can fall below what a uniform
    # 6-point sampler survives.  Tracked rows are frame-to-frame precise.
    logits = jnp.concatenate([
        jnp.full((q2.shape[0],), 2.0, jnp.float32),
        jnp.zeros((m3d.query_idx.shape[0],), jnp.float32),
    ])
    # Motion prior: the last registered pose enters the hypothesis pool (a
    # constant-position model).  With the top-k LO refinement inside
    # ransac_pnp this removes the sampling-starvation failure mode that
    # killed long runs (~1 key in 5 collapsed a healthy frame to <12
    # inliers at ~35% inlier rate; see ransac_pnp docstring).
    prev_pose = jax.tree.map(
        lambda a: a[jnp.maximum(cam_idx - 1, 0)], state.poses
    )
    pnp = ransac_pnp(
        k_pnp, X3d, uvn, corr_m,
        num_hypotheses=config.pnp_hypotheses,
        inlier_threshold=config.two_view.ransac.inlier_threshold
        / jnp.maximum(K.fx, 1.0),
        sample_logits=logits,
        prior_pose=prev_pose,
    )
    registered = pnp.num_inliers >= config.pnp_min_inliers

    # -- 3. observations + descriptor refresh ------------------------------
    # Deduplicate (the same query may appear via track AND bank): keep the
    # first inlier occurrence per landmark slot.
    O_cap = state.obs_cam.shape[0]
    inl = jnp.logical_and(pnp.inlier_mask, corr_m)
    n_corr = corr_q.shape[0]
    first_of_lm = jnp.full((L + 1,), n_corr, jnp.int32).at[
        jnp.where(inl, corr_l, L)
    ].min(jnp.arange(n_corr, dtype=jnp.int32), mode="drop")
    is_first = first_of_lm[corr_l] == jnp.arange(n_corr)
    good_obs = jnp.logical_and(jnp.logical_and(inl, is_first), registered)

    sp = _append_positions(O_cap, state.num_obs, good_obs)
    obs_cam = state.obs_cam.at[sp].set(cam_idx, mode="drop")
    obs_lm = state.obs_lm.at[sp].set(corr_l, mode="drop")
    obs_uv = state.obs_uv.at[sp].set(uv, mode="drop")
    obs_mask = state.obs_mask.at[sp].set(True, mode="drop")
    num_obs = jnp.minimum(
        state.num_obs + jnp.sum(good_obs.astype(jnp.int32)), O_cap
    ).astype(jnp.int32)

    d_seen = jnp.take(desc, corr_q, axis=0)
    upd = good_obs
    lm_desc = state.lm_desc.at[jnp.where(upd, corr_l, L)].set(
        jnp.where(upd[:, None], d_seen, 0.0), mode="drop"
    )

    # -- 4. new landmarks: frame↔prev matches whose prev keypoint has no
    # landmark AND whose query landed no map observation this frame --------
    has_obs_q = jnp.zeros((n + 1,), bool).at[
        jnp.where(good_obs, corr_q, n)
    ].set(True, mode="drop")[:n]
    cand = jnp.logical_and(
        jnp.logical_and(m2d.mask, ~tracked),
        ~jnp.take(has_obs_q, q2),
    )

    prev_cam = cam_idx - 1
    prev_pose = jax.tree.map(lambda a: a[jnp.maximum(prev_cam, 0)], state.poses)
    P1 = prev_pose.matrix34()
    P2 = pnp.pose.matrix34()
    uv_c = jnp.take(kps_xy, q2, axis=0)
    uv_p = jnp.take(state.prev_kps_xy, p2_, axis=0)
    Xn, cheir = triangulate_dlt(P1, P2, K.normalize_points(uv_p),
                                K.normalize_points(uv_c))
    zc = pnp.pose.transform(Xn)[..., 2]
    new_ok = jnp.logical_and(jnp.logical_and(cand, cheir),
                             jnp.logical_and(zc > 0.05, zc < 100.0))
    # Reprojection gate in BOTH views: a false frame↔prev match triangulates
    # to a point whose rays don't meet — cheirality+depth alone let it into
    # the map with a 10-100+ px residual, and enough of those collapse
    # registration a few frames later (measured: map residual p50 0.75 px
    # but RMS 13-26 px before this gate; the 87→40→9→1 inlier death spiral
    # on the 100-frame sequence traced back to exactly these).
    thr_px = config.two_view.ransac.inlier_threshold

    def _reproj_err_px(pose, uv_obs):
        Xc = pose.transform(Xn)
        z = jnp.maximum(Xc[..., 2:3], 1e-6)
        uvn_hat = Xc[..., :2] / z
        d = uvn_hat - K.normalize_points(uv_obs)
        return jnp.linalg.norm(d, axis=-1) * K.fx

    err_p = _reproj_err_px(prev_pose, uv_p)
    err_c = _reproj_err_px(pnp.pose, uv_c)
    new_ok = jnp.logical_and(
        new_ok, jnp.logical_and(err_p < thr_px, err_c < thr_px)
    )
    # Only trusted poses may grow the map: a marginal (just ≥ pnp_min)
    # registration still updates the trajectory, but letting it spawn
    # landmarks poisons the frontier the next frames must localize against.
    trusted = pnp.num_inliers >= config.keyframe_min_inliers
    new_ok = jnp.logical_and(new_ok,
                             jnp.logical_and(registered, trusted))

    lsp = _append_positions(L, state.num_lms, new_ok)  # rejects → L (dropped)
    lok = lsp < L
    d_new = jnp.take(desc, q2, axis=0)
    X_new = state.X.at[lsp].set(Xn, mode="drop")
    lm_mask_new = state.lm_mask.at[lsp].set(True, mode="drop")
    lm_desc = lm_desc.at[lsp].set(d_new, mode="drop")
    num_lms = jnp.minimum(
        state.num_lms + jnp.sum(new_ok.astype(jnp.int32)), L
    ).astype(jnp.int32)

    # two observations for each new landmark (prev cam + this cam)
    def add_obs(carry, cam_i, uv_i):
        obs_cam, obs_lm, obs_uv, obs_mask, cursor = carry
        s2 = _append_positions(obs_cam.shape[0], cursor, lok)
        obs_cam = obs_cam.at[s2].set(cam_i, mode="drop")
        obs_lm = obs_lm.at[s2].set(lsp, mode="drop")
        obs_uv = obs_uv.at[s2].set(uv_i, mode="drop")
        obs_mask = obs_mask.at[s2].set(True, mode="drop")
        cursor = jnp.minimum(cursor + jnp.sum(lok.astype(jnp.int32)),
                             obs_cam.shape[0]).astype(jnp.int32)
        return (obs_cam, obs_lm, obs_uv, obs_mask, cursor)

    obs = (obs_cam, obs_lm, obs_uv, obs_mask, num_obs)
    obs = add_obs(obs, prev_cam, uv_p)
    obs = add_obs(obs, cam_idx, uv_c)

    # -- write pose --------------------------------------------------------
    poses = jax.tree.map(
        lambda a, b: a.at[cam_idx].set(jnp.where(registered, b, a[cam_idx])),
        state.poses, pnp.pose,
    )
    cam_mask = state.cam_mask.at[cam_idx].set(registered)
    num_cams = jnp.where(registered, cam_idx + 1, state.num_cams).astype(jnp.int32)

    # track associations for the CURRENT frame's keypoints: map-observation
    # queries keep their landmark, new-landmark queries get their new slot
    prev_lm_new = jnp.full((n,), -1, jnp.int32)
    prev_lm_new = prev_lm_new.at[jnp.where(good_obs, corr_q, n)].set(
        corr_l.astype(jnp.int32), mode="drop"
    )
    prev_lm_new = prev_lm_new.at[jnp.where(lok, q2, n)].set(
        lsp.astype(jnp.int32), mode="drop"
    )

    new_state = state.replace(
        poses=poses, cam_mask=cam_mask,
        X=X_new, lm_mask=lm_mask_new, lm_desc=lm_desc,
        obs_cam=obs[0], obs_lm=obs[1], obs_uv=obs[2], obs_mask=obs[3],
        num_obs=obs[4], num_lms=num_lms, num_cams=num_cams,
        prev_kps_xy=jnp.where(registered, kps_xy, state.prev_kps_xy),
        prev_desc=jnp.where(registered, desc, state.prev_desc),
        prev_mask=jnp.where(registered, fmask, state.prev_mask),
        prev_lm=jnp.where(registered, prev_lm_new, state.prev_lm),
    )
    stats = StepStats(
        registered=registered,
        num_pnp_inliers=pnp.num_inliers,
        num_new_landmarks=jnp.sum(new_ok.astype(jnp.int32)),
        pose=pnp.pose,
    )
    return new_state, stats


@functools.partial(jax.jit, static_argnames=("config", "window"))
def local_bundle_adjust(
    state: SfMState,
    K: CameraIntrinsics,
    config: SfMConfig,
    window: int = 8,
) -> Tuple[SfMState, Array]:
    """Windowed BA over the last ``window`` registered cameras at a REDUCED
    static observation capacity (``config.local_ba_obs`` rows).

    The previous full-table form re-solved all ``max_observations``
    (32 768) rows every call although the window constrains only the
    recent suffix.
    Observations append in time order, so the window's measurements are
    exactly the LAST rows of the table — one ``dynamic_slice`` extracts
    them (no sort, no compaction scatter).

    Gauge/anchoring: out-of-window cameras in the slice stay gauge-fixed
    (the trick the full-table form used), and landmarks created BEFORE the
    slice — whose older anchoring observations the slice no longer carries
    — are held fixed via ``SparseBAState.lm_fixed``: their in-slice
    observations act as PnP-like absolute constraints on the free cameras,
    pinning the monocular scale gauge the out-of-slice rows used to pin.
    Landmark slots are allocated append-only, so "created before the
    slice" is exactly ``slot ≤ max(obs_lm[row < start])`` — one masked
    max-reduction, no scatter.
    """
    C = state.cam_mask.shape[0]
    L = state.X.shape[0]
    O = state.obs_cam.shape[0]
    Ow = min(config.local_ba_obs, O)
    first = jnp.maximum(state.num_cams - window, 0)

    in_win = jnp.logical_and(
        jnp.arange(C) >= first, jnp.arange(C) < state.num_cams
    )

    start = jnp.clip(state.num_obs - Ow, 0, O - Ow)
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, Ow, axis=0)
    pre = jnp.logical_and(state.obs_mask, jnp.arange(O) < start)
    max_slot_pre = jnp.max(jnp.where(pre, state.obs_lm, -1))
    lm_fixed = jnp.arange(L) <= max_slot_pre

    ba_state = make_sparse_ba_state(
        state.poses, state.X, sl(state.obs_cam), sl(state.obs_lm),
        sl(state.obs_uv), sl(state.obs_mask), num_fixed_cameras=0,
    )
    # fix everything outside the window, the window's first camera, and
    # always cameras 0-1 (two fixed cameras pin the 7th, scale, gauge DOF)
    fixed = jnp.logical_or(~in_win, jnp.arange(C) <= first)
    fixed = jnp.logical_or(fixed, jnp.arange(C) <= 1)
    ba_state = ba_state.replace(cam_fixed=fixed, lm_fixed=lm_fixed)
    out, stats_ba = bundle_adjust_sparse(ba_state, K, config.ba)

    # cam_fixed / lm_fixed zero the respective updates EXACTLY inside the
    # solver, so out.poses/out.X already equal the inputs on frozen rows —
    # no write-back masking needed.
    return state.replace(poses=out.poses, X=out.X), stats_ba.final_cost


@functools.partial(
    jax.jit, static_argnames=("config", "ba_every", "window")
)
def register_frames_chunk(
    state: SfMState,
    kps_xy: Array,      # [F, N, 2]
    desc: Array,        # [F, N, D]
    fmask: Array,       # [F, N]
    frame_idx: Array,   # [F] int32 global frame numbers (for the BA cadence)
    K: CameraIntrinsics,
    key: Array,
    config: SfMConfig,
    ba_every: int,
    window: int,
) -> Tuple[SfMState, StepStats]:
    """Register a CHUNK of frames in one dispatch: ``lax.scan`` over the
    per-frame registration step with a ``lax.cond``-gated local BA every
    ``ba_every`` frames — the ``build_submap`` shape applied to the
    flagship single-host driver.

    This removes the per-frame host sync (VERDICT r2 item 5): the old
    one-``bool(st.registered)``-per-frame loop waited on the device every
    frame; here the host sees one fetch per chunk.
    """
    def body(carry, x):
        state, key = carry
        xy, d, m, i = x
        key, ki = jax.random.split(key)
        state, st = register_frame(state, xy, d, m, K, ki, config)
        do_ba = jnp.logical_and(st.registered, (i % ba_every) == 0)
        state = jax.lax.cond(
            do_ba,
            lambda s: local_bundle_adjust(s, K, config, window)[0],
            lambda s: s,
            state,
        )
        return (state, key), st

    (state, _), stats = jax.lax.scan(
        body, (state, key), (kps_xy, desc, fmask, frame_idx)
    )
    return state, stats


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SfMResult:
    state: SfMState
    trajectory: Array            # [C, 3] camera centers (world frame)
    registered: List[bool]
    stats: List[StepStats]


def camera_centers(poses: Pose, mask: Array) -> Array:
    """World-frame camera centers −Rᵀt (masked rows zeroed)."""
    c = -jnp.einsum("cij,ci->cj", jnp.swapaxes(poses.R, -1, -2), poses.t)
    return jnp.where(mask[:, None], c, 0.0)


def run_incremental_sfm(
    frames,                      # iterable of (kps_xy [N,2], desc [N,D], mask [N])
    K: CameraIntrinsics,
    config: SfMConfig = SfMConfig(),
    seed: int = 0,
    ba_every: int = 4,
    chunk_size: int = 16,
) -> SfMResult:
    """Chunked device loop: bootstrap on the first two frames, then register
    the rest ``chunk_size`` frames per dispatch (scan + cond-gated local BA
    inside ``register_frames_chunk``), fetching stats once per chunk
    (SURVEY.md §3.2 stack; §7 "host loop vs device loop").

    ``chunk_size=1`` reproduces the old frame-at-a-time cadence (one
    dispatch per frame) when keyframe I/O must interleave."""
    frames = list(frames)
    assert len(frames) >= 2, "need at least two frames"
    n_feat, d_dim = frames[0][1].shape

    state = init_sfm_state(config, n_feat, d_dim)
    key = jax.random.PRNGKey(seed)
    stats_all: List[StepStats] = []
    registered = [True, True]

    key, k0 = jax.random.split(key)
    state, st = bootstrap_two_view(
        state, frames[0][0], frames[0][1], frames[0][2],
        frames[1][0], frames[1][1], frames[1][2], K, k0, config,
    )
    stats_all.append(st)

    rest = frames[2:]
    for c0 in range(0, len(rest), chunk_size):
        ch = rest[c0 : c0 + chunk_size]
        xy = jnp.stack([f[0] for f in ch])
        d = jnp.stack([f[1] for f in ch])
        m = jnp.stack([f[2] for f in ch])
        idx = jnp.arange(c0 + 2, c0 + 2 + len(ch), dtype=jnp.int32)
        key, kc = jax.random.split(key)
        state, sts = register_frames_chunk(
            state, xy, d, m, idx, K, kc, config, ba_every,
            config.local_ba_window,
        )
        sts_host = jax.device_get(sts)  # ONE round-trip per chunk
        for j in range(len(ch)):
            stj = jax.tree.map(lambda a: a[j], sts_host)
            stats_all.append(stj)
            registered.append(bool(stj.registered))

    state, _ = local_bundle_adjust(state, K, config,
                                   window=config.local_ba_window)
    traj = camera_centers(state.poses, state.cam_mask)
    return SfMResult(state=state, trajectory=traj, registered=registered,
                     stats=stats_all)
