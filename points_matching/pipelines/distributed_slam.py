"""Distributed SLAM via parallel submaps (BASELINE config 4: "KITTI 00
full sequence — distributed SLAM with keyframes and map blocks sharded over
hosts"; SURVEY.md §3.2 ``slam_distributed`` and §2.3 P1/P4).

The reference processes one image pair on one CPU thread (`Points
Matching/main.cpp:9-146`); sequential visual SLAM is inherently serial per
frame, so scaling it over a device mesh needs a decomposition that creates
parallelism.  The design here is **submapping**:

1. **Split** the sequence into S overlapping segments.
2. **Build submaps in parallel** — each segment runs the full incremental
   pipeline (bootstrap → PnP registration → windowed BA) as ONE
   ``lax.scan`` over frames, ``vmap``-ed over segments with the segment
   axis sharded on the mesh's ``data`` axis.  GSPMD places each submap on
   its own device group; no cross-device traffic during building (the
   all-gather happens once at the end when results are pulled together).
3. **Align** consecutive submaps on the host with a Sim(3) estimated from
   the overlap frames they share — rotation from the chordal mean of
   relative camera orientations (robust to collinear camera centers,
   unlike center-only Umeyama), scale from center spreads, translation
   from center means.  Monocular submaps each carry an arbitrary scale;
   this is where it is reconciled.
4. **Refine globally** with landmark-sharded distributed bundle adjustment
   (``parallel/sharded_ba.py``): the merged [C_g, L_g] problem's landmark
   axis is split over the ``model`` axis and XLA reduces the Schur system
   with one psum.

Everything device-side is static-shape: segments are equal length, map
capacities fixed, validity masked.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from points_matching.ba.lm import (
    BAState,
    LMStats,
    bundle_adjust,
    grid_from_obs,
    make_ba_state,
)
from points_matching.ba.sparse import (
    bundle_adjust_sparse,
    make_sparse_ba_state,
)
from points_matching.core.config import SfMConfig
from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.parallel.mesh import DATA_AXIS, MODEL_AXIS
from points_matching.parallel.sharded_ba import (
    distributed_bundle_adjust,
    distributed_bundle_adjust_sparse,
)
from points_matching.pipelines.sfm import (
    SfMState,
    bootstrap_two_view,
    camera_centers,
    init_sfm_state,
    local_bundle_adjust,
    register_frame,
)

Array = jax.Array


# ---------------------------------------------------------------------------
# Stage 1-2: parallel submap building (device)
# ---------------------------------------------------------------------------

def build_submap(
    kps_xy: Array,     # [T, N, 2]
    desc: Array,       # [T, N, D]
    fmask: Array,      # [T, N]
    K: CameraIntrinsics,
    key: Array,
    config: SfMConfig,
    ba_every: int = 4,
) -> Tuple[SfMState, Array]:
    """One segment → one submap: bootstrap on frames 0-1, ``lax.scan``
    registration over the rest (windowed BA every ``ba_every`` frames via
    ``lax.cond`` — without it drift compounds and PnP inlier counts decay
    across the segment), full-window BA at the end.

    Pure and vmappable; returns (state, registered [T] bool).
    """
    T, N, _ = kps_xy.shape
    D = desc.shape[-1]
    state = init_sfm_state(config, N, D)
    key, k0 = jax.random.split(key)
    state, st0 = bootstrap_two_view(
        state, kps_xy[0], desc[0], fmask[0],
        kps_xy[1], desc[1], fmask[1], K, k0, config,
    )

    def step(carry, frame):
        st, k = carry
        xy, d, m, i = frame
        k, ki = jax.random.split(k)
        st, stats = register_frame(st, xy, d, m, K, ki, config)
        st = lax.cond(
            jnp.logical_and(stats.registered, i % ba_every == 0),
            lambda s: local_bundle_adjust(
                s, K, config, window=config.local_ba_window)[0],
            lambda s: s,
            st,
        )
        return (st, k), stats.registered

    (state, _), regs = lax.scan(
        step, (state, key),
        (kps_xy[2:], desc[2:], fmask[2:], jnp.arange(2, T)),
    )
    state, _ = local_bundle_adjust(state, K, config, window=T)
    regs = jnp.concatenate(
        [jnp.stack([st0.registered, st0.registered]), regs]
    )
    return state, regs


@functools.partial(jax.jit, static_argnames=("config",))
def _build_submaps_batched(
    kps_xy: Array,     # [S, T, N, 2]
    desc: Array,       # [S, T, N, D]
    fmask: Array,      # [S, T, N]
    K: CameraIntrinsics,
    keys: Array,       # [S, 2]
    config: SfMConfig,
) -> Tuple[SfMState, Array]:
    fn = lambda a, b, c, k: build_submap(a, b, c, K, k, config)
    return jax.vmap(fn)(kps_xy, desc, fmask, keys)


def build_submaps(
    kps_xy: Array, desc: Array, fmask: Array,
    K: CameraIntrinsics, key: Array, config: SfMConfig,
    mesh: Optional[Mesh] = None,
) -> Tuple[SfMState, Array]:
    """Build all S submaps; with a mesh the segment axis is sharded on
    ``data`` so device groups build their submaps concurrently."""
    S = kps_xy.shape[0]
    keys = jax.random.split(key, S)
    if mesh is not None:
        n_data = mesh.shape[DATA_AXIS]
        if S % n_data != 0:
            raise ValueError(
                f"num segments ({S}) must divide the data axis ({n_data})"
            )
        sh = NamedSharding(mesh, P(DATA_AXIS))
        kps_xy, desc, fmask, keys = (
            jax.device_put(x, sh) for x in (kps_xy, desc, fmask, keys)
        )
        K = jax.device_put(K, NamedSharding(mesh, P()))
    return _build_submaps_batched(kps_xy, desc, fmask, K, keys, config)


# ---------------------------------------------------------------------------
# Stage 3: Sim(3) submap alignment (host — tiny data)
# ---------------------------------------------------------------------------

def sim3_from_shared_frames(
    R_l: np.ndarray, t_l: np.ndarray,   # [J, 3, 3], [J, 3] local submap poses
    R_g: np.ndarray, t_g: np.ndarray,   # [J, 3, 3], [J, 3] same frames, global
    valid: np.ndarray,                  # [J] both-registered mask
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Sim(3) (c, R_a, t_a) with x_global = c·R_a·x_local + t_a, from J
    overlap frames estimated in both coordinate systems.

    Poses are world→camera (x_cam = R x_w + t).  For a shared physical
    camera, global pose relates to local by R_gj = R_lj·R_aᵀ, so each frame
    votes R_a = R_gjᵀ·R_lj; the chordal mean (SVD-projected sum) fuses the
    votes.  Scale comes from the ratio of camera-center spreads, translation
    from the center means — full-orientation alignment stays well-posed even
    when the overlap centers are collinear (straight driving, the common
    case on KITTI), where center-only Umeyama loses the roll axis.
    """
    idx = np.flatnonzero(valid)
    if idx.size < 2:
        raise ValueError(f"need >= 2 shared registered frames, got {idx.size}")
    R_l, t_l, R_g, t_g = R_l[idx], t_l[idx], R_g[idx], t_g[idx]

    M = np.einsum("jki,jkl->il", R_g, R_l)  # Σ R_gᵀ R_l
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R_a = U @ D @ Vt

    C_l = -np.einsum("jki,jk->ji", R_l, t_l)  # centers = -Rᵀ t
    C_g = -np.einsum("jki,jk->ji", R_g, t_g)
    mu_l, mu_g = C_l.mean(0), C_g.mean(0)
    spread_l = np.linalg.norm(C_l - mu_l, axis=-1).sum()
    spread_g = np.linalg.norm(C_g - mu_g, axis=-1).sum()
    c = float(spread_g / max(spread_l, 1e-12)) if spread_l > 1e-9 else 1.0
    t_a = mu_g - c * R_a @ mu_l
    return c, R_a, t_a


def _apply_sim3_to_poses(
    R: np.ndarray, t: np.ndarray, c: float, R_a: np.ndarray, t_a: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """World→camera poses re-expressed after x_g = c·R_a·x_l + t_a (camera
    frame uniformly rescaled by c, consistent with landmark transport):
    R' = R·R_aᵀ,  t' = c·t − R·R_aᵀ·t_a."""
    R_new = R @ R_a.T
    t_new = c * t - np.einsum("cij,j->ci", R_new, t_a)
    return R_new, t_new


# ---------------------------------------------------------------------------
# Stage 3-4: merge + global BA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistributedSlamResult:
    poses: Pose                 # [C_g] global world→camera
    cam_valid: np.ndarray       # [C_g] bool
    X: Array                    # [L_g, 3] merged landmarks (post-BA)
    trajectory: np.ndarray      # [C_g, 3] camera centers
    registered_per_segment: np.ndarray  # [S, T]
    ba_stats: Optional[LMStats]


def merge_submaps(
    states: SfMState,           # stacked [S, ...] (from build_submaps)
    regs: Array,                # [S, T]
    overlap: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Chain Sim(3) alignments and fuse submaps into one global problem.

    Returns (R_g [C_g,3,3], t_g [C_g,3], cam_valid [C_g]) plus a dict of
    merged observation arrays + landmark arrays ready for ``grid_from_obs``.
    Segment s's local frame j is global frame s·(T−overlap)+j, so overlap
    frames coincide and observations from both submaps attach to the same
    global camera.
    """
    st = jax.device_get(states)
    regs = np.asarray(jax.device_get(regs))
    S, T = regs.shape
    stride = T - overlap
    C_g = (S - 1) * stride + T
    C_cap = st.cam_mask.shape[1]
    L_cap = st.X.shape[1]

    R_all = np.asarray(st.poses.R)      # [S, C_cap, 3, 3]
    t_all = np.asarray(st.poses.t)

    # Camera SLOTS are registration-ordered (a frame that fails PnP does not
    # advance num_cams — pipelines/sfm.py register_frame), so build the
    # frame↔slot maps per segment.  Bootstrap always occupies slots 0-1.
    frame2slot = np.full((S, T), -1, np.int64)
    slot2frame = np.full((S, C_cap), -1, np.int64)
    for s in range(S):
        slot = 0
        for j in range(T):
            if j < 2 or regs[s, j]:
                frame2slot[s, j] = slot
                slot2frame[s, slot] = j
                slot += 1

    def frame_poses(seg):
        """Per-FRAME poses [T, 3, 3]/[T, 3] (identity where unregistered)."""
        sl = np.clip(frame2slot[seg], 0, C_cap - 1)
        return R_all[seg, sl], t_all[seg, sl]

    # chain Sim3: segment 0 defines the global frame
    transforms = [(1.0, np.eye(3), np.zeros(3))]
    R_geo = np.tile(np.eye(3), (C_g, 1, 1))
    t_geo = np.zeros((C_g, 3))
    cam_valid = np.zeros((C_g,), bool)

    def place(seg, c, R_a, t_a, start_j):
        Rf, tf = frame_poses(seg)
        Rn, tn = _apply_sim3_to_poses(Rf, tf, c, R_a, t_a)
        base = seg * stride
        for j in range(start_j, T):
            gi = base + j
            if regs[seg, j] and frame2slot[seg, j] >= 0 and not cam_valid[gi]:
                R_geo[gi], t_geo[gi] = Rn[j], tn[j]
                cam_valid[gi] = True

    place(0, *transforms[0], 0)
    for s in range(1, S):
        # overlap frames: local j<overlap in segment s == global
        # (s-1)*stride + stride + j — already placed by segment s-1
        gi0 = s * stride
        Rf, tf = frame_poses(s)
        both = np.logical_and(
            np.logical_and(regs[s, :overlap], frame2slot[s, :overlap] >= 0),
            cam_valid[gi0: gi0 + overlap],
        )
        c, R_a, t_a = sim3_from_shared_frames(
            Rf[:overlap], tf[:overlap],
            R_geo[gi0: gi0 + overlap], t_geo[gi0: gi0 + overlap], both,
        )
        transforms.append((c, R_a, t_a))
        place(s, c, R_a, t_a, overlap)

    # landmarks: segment s's slot l is global slot s·L_cap + l
    X_parts, lmask_parts = [], []
    for s in range(S):
        c, R_a, t_a = transforms[s]
        X_parts.append(np.asarray(st.X[s]) @ (c * R_a).T + t_a)
        lmask_parts.append(np.asarray(st.lm_mask[s]))
    X_g = np.concatenate(X_parts)
    lm_valid = np.concatenate(lmask_parts)

    # observations: local SLOT → local frame → global camera index
    oc_local = np.asarray(st.obs_cam)                      # [S, O] slots
    frames_of = np.take_along_axis(
        slot2frame, np.clip(oc_local, 0, C_cap - 1), axis=1
    )                                                      # [S, O] frames
    obs_cam = (frames_of + (np.arange(S) * stride)[:, None]).reshape(-1)
    obs_lm = (np.asarray(st.obs_lm)
              + (np.arange(S) * L_cap)[:, None]).reshape(-1)
    obs_uv = np.asarray(st.obs_uv).reshape(-1, 2)
    obs_mask = np.logical_and(
        np.asarray(st.obs_mask).reshape(-1), frames_of.reshape(-1) >= 0
    )
    obs_cam = np.clip(obs_cam, 0, C_g - 1)
    # drop observations of frames that never got a valid global pose
    obs_mask = np.logical_and(obs_mask, cam_valid[obs_cam])

    merged = dict(
        obs_cam=obs_cam.astype(np.int32), obs_lm=obs_lm.astype(np.int32),
        obs_uv=obs_uv.astype(np.float32), obs_mask=obs_mask,
        X=X_g.astype(np.float32), lm_valid=lm_valid,
    )
    return R_geo, t_geo, cam_valid, merged


def segment_frames(
    kps_xy: Array, desc: Array, fmask: Array, segment_len: int, overlap: int
) -> Tuple[Array, Array, Array, int]:
    """[F, ...] frame arrays → [S, T, ...] overlapping segments.  Trailing
    frames that do not fill a segment are dropped (returned count says how
    many frames were used)."""
    if overlap < 3:
        raise ValueError("need overlap >= 3 to estimate inter-submap Sim(3)")
    if segment_len <= overlap:
        raise ValueError("segment_len must exceed overlap")
    F = kps_xy.shape[0]
    stride = segment_len - overlap
    S = (F - overlap) // stride
    if S < 1:
        raise ValueError(f"sequence too short: {F} frames < {segment_len}")
    used = (S - 1) * stride + segment_len

    idx = np.arange(S)[:, None] * stride + np.arange(segment_len)[None, :]
    return kps_xy[idx], desc[idx], fmask[idx], used


def run_distributed_slam(
    kps_xy: Array,     # [F, N, 2]
    desc: Array,       # [F, N, D]
    fmask: Array,      # [F, N]
    K: CameraIntrinsics,
    config: SfMConfig = SfMConfig(),
    mesh: Optional[Mesh] = None,
    segment_len: int = 16,
    overlap: int = 4,
    seed: int = 0,
    global_ba: bool = True,
    ba_config=None,
    outlier_gate_px: float = 10.0,
) -> DistributedSlamResult:
    """Full distributed SLAM: segment → parallel submaps → Sim(3) merge →
    landmark-sharded global BA.  See module docstring for the design.

    The merge step inevitably leaves outliers (duplicate landmarks from the
    overlap region, Sim(3) residual misalignment, per-submap mismatches), so
    before the global solve observations whose reprojection error exceeds
    ``outlier_gate_px`` (or whose landmark sits behind its camera) are
    masked, and the BA defaults to a Huber loss (δ=3 px) unless
    ``ba_config`` overrides it."""
    seg_k, seg_d, seg_m, used = segment_frames(
        kps_xy, desc, fmask, segment_len, overlap
    )
    S = seg_k.shape[0]
    states, regs = build_submaps(
        seg_k, seg_d, seg_m, K, jax.random.PRNGKey(seed), config, mesh
    )
    R_g, t_g, cam_valid, merged = merge_submaps(states, regs, overlap)
    C_g = R_g.shape[0]
    L_g = merged["X"].shape[0]

    # ---- outlier gate (host, tiny data) ---------------------------------
    fx, fy = float(K.fx), float(K.fy)
    cx, cy = float(K.cx), float(K.cy)
    Xo = merged["X"][merged["obs_lm"]]
    Ro, to = R_g[merged["obs_cam"]], t_g[merged["obs_cam"]]
    Xc = np.einsum("oij,oj->oi", Ro, Xo) + to
    z = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
    err = np.hypot(u - merged["obs_uv"][:, 0], v - merged["obs_uv"][:, 1])
    keep = np.logical_and(z > 1e-3, np.nan_to_num(err, nan=np.inf)
                          <= outlier_gate_px)
    merged["obs_mask"] = np.logical_and(merged["obs_mask"], keep)

    poses = Pose(R=jnp.asarray(R_g), t=jnp.asarray(t_g))
    ba_stats = None
    X_out = jnp.asarray(merged["X"])
    if global_ba:
        # Observation-list (sparse) BA: the merged global problem is exactly
        # the regime the dense [C, L] grid cannot scale to (VERDICT r2
        # item 4) — O(observations) memory, duplicate (c, l) rows handled
        # additively, and the observation axis shards over the mesh.
        ba_state = make_sparse_ba_state(
            poses, X_out,
            jnp.asarray(merged["obs_cam"]), jnp.asarray(merged["obs_lm"]),
            jnp.asarray(merged["obs_uv"]), jnp.asarray(merged["obs_mask"]),
        )
        fixed = jnp.logical_or(~jnp.asarray(cam_valid), jnp.arange(C_g) <= 1)
        ba_state = ba_state.replace(cam_fixed=fixed)
        # The windowed-BA budget in SfMConfig.ba (6 LM × 16 PCG, rtol 1e-4)
        # assumes a near-converged warm start; this one-shot merged global
        # problem starts COLD, so when no explicit ba_config is given it
        # gets an offline-scale budget instead of inheriting the window's.
        cfg = ba_config if ba_config is not None else dataclasses.replace(
            config.ba,
            huber_delta=max(config.ba.huber_delta, 3.0),
            max_iterations=max(config.ba.max_iterations, 20),
            pcg_iterations=max(config.ba.pcg_iterations, 50),
            rtol=min(config.ba.rtol, 1e-6),
        )
        if mesh is not None and MODEL_AXIS in mesh.shape:
            out, ba_stats = distributed_bundle_adjust_sparse(
                ba_state, K, mesh, cfg
            )
        else:
            out, ba_stats = bundle_adjust_sparse(ba_state, K, cfg)
        poses = jax.tree.map(
            lambda new, old: jnp.where(
                np.asarray(cam_valid).reshape((C_g,) + (1,) * (new.ndim - 1)),
                new, old,
            ),
            out.poses, poses,
        )
        X_out = out.X

    traj = np.asarray(jax.device_get(
        camera_centers(poses, jnp.asarray(cam_valid))
    ))
    return DistributedSlamResult(
        poses=poses, cam_valid=cam_valid, X=X_out, trajectory=traj,
        registered_per_segment=np.asarray(jax.device_get(regs)),
        ba_stats=ba_stats,
    )
