"""Sparse observation-list bundle adjustment — O(observations) memory.

The dense-grid engine (``ba/lm.py`` + ``ba/schur.py``) materializes the
camera×landmark coupling ``W`` as ``[C, L, 6, 3]``; at BASELINE scale
(hundreds of cameras × 10⁴–10⁶ landmarks) that is terabytes.  This module
is the SURVEY.md §7 "sparse BA on dense hardware" layout: everything is
computed directly from the flat observation arrays ``(cam_idx, lm_idx, uv)``
— per-observation residual/Jacobian evaluation (closed-form, elementwise),
normal-equation blocks by ``segment_sum`` scatter-adds, and the reduced
camera system solved by Jacobi-preconditioned CG with an *implicit* Schur
matvec (the classic ITERATIVE_SCHUR structure):

    S x = U x − Σ_l W_{·l} V_l⁻¹ (Σ_o W_oᵀ x_{cam(o)})

assembled as two segment-sums per matvec — ``[C, L]`` never exists.

Duplicate (c, l) observations are handled exactly (their normal-equation
contributions add), unlike the dense grid's last-write-wins conversion.

Distribution: shard the observation axis; every segment_sum becomes a
local partial + ``psum`` over the mesh.  That plan is implemented here —
every assembly/matvec helper takes ``axis_name``; when set (inside a
``shard_map`` whose per-observation arrays are split on that mesh axis,
see ``parallel.sharded_ba.distributed_bundle_adjust_sparse``) each
segment_sum reduces the local observations and a ``psum`` completes the
global sum, leaving U/V/g/S·x replicated while Wo/cam/lm stay local.
Replaces nothing — the dense grid stays the fastest layout for small,
dense problems (two-view, local windows ≤ a few cameras × few-k
landmarks); ``pipelines/sfm.py`` picks per problem size.

(Extension surface beyond the reference, which has no BA at all —
``Points Matching/main.cpp`` stops at F; SURVEY.md §2.3/§7 stage 6.)
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from points_matching.core import struct
from jax import Array

from points_matching.core.precision import f32_matmuls
from points_matching.ba.residuals import _residual_one
from points_matching.ba.schur import _damp, _inv3
from points_matching.core.config import BAConfig
from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.geometry.se3 import se3_exp


def _preduce(x, axis_name: Optional[str]):
    """Complete a segment_sum across the observation shards: identity when
    single-device, ``psum`` when running under shard_map."""
    if axis_name is None:
        return x
    return jax.lax.psum(x, axis_name)


class SegOps(NamedTuple):
    """Reduction/expansion strategy over the observation axis.

    'scatter' uses ``segment_sum`` and indexed gathers.  'sorted' replaces
    them with scatter-free forms:

      * camera side (C small): one [C, O] one-hot built once per BA call;
        seg_cam = onehot @ v (a GEMM), expand_cam = onehotᵀ @ x — exact
        (0/1 × f32 at HIGHEST precision).
      * landmark side (L large — a [L, O] one-hot cannot exist): sort the
        observations by landmark once per call, then every segment sum is
        an O-cumsum + two [L] boundary gathers (~4e-6 relative error from
        prefix cancellation at 32k observations — far below the f32 noise
        of the normal equations themselves).

    The indices are fixed across LM/PCG iterations, so the sort and the
    one-hot amortize over the whole solve (~100 reductions per call at
    default iteration budgets).
    """

    seg_cam: "object"
    seg_lm: "object"
    expand_cam: "object"
    gather_lm: "object"


def _scatter_ops(C: int, L: int, cam: Array, lm: Array) -> SegOps:
    return SegOps(
        seg_cam=lambda v: jax.ops.segment_sum(v, cam, num_segments=C),
        seg_lm=lambda v: jax.ops.segment_sum(v, lm, num_segments=L),
        expand_cam=lambda x: x[cam],
        gather_lm=lambda v: v[lm],
    )


def _sorted_ops(
    C: int, L: int, cam_sorted: Array, lm_sorted: Array, mask_sorted: Array
) -> SegOps:
    """Build the sorted-layout strategy; observation arrays MUST already be
    in ascending-landmark order with masked rows last (see
    ``_sort_obs_by_landmark``)."""
    O = cam_sorted.shape[0]
    onehot = jnp.logical_and(
        jnp.arange(C)[:, None] == cam_sorted[None, :], mask_sorted[None, :]
    ).astype(jnp.float32)                                   # [C, O]
    key = jnp.where(mask_sorted, jnp.clip(lm_sorted, 0, L - 1), L)
    starts = jnp.searchsorted(key, jnp.arange(L), side="left")
    ends = jnp.searchsorted(key, jnp.arange(L), side="right")

    # HIGHEST: the values operand must not be rounded to TF32/bf16.
    _ONEHOT_PREC = jax.lax.Precision.HIGHEST

    def seg_cam(v):
        flat = v.reshape(O, -1)
        out = jnp.einsum("co,ok->ck", onehot, flat, precision=_ONEHOT_PREC)
        return out.reshape((C,) + v.shape[1:])

    def seg_lm(v):
        flat = v.reshape(O, -1)
        c = jnp.cumsum(flat, axis=0)
        cz = jnp.concatenate(
            [jnp.zeros((1, flat.shape[1]), flat.dtype), c], axis=0
        )
        out = cz[ends] - cz[starts]
        return out.reshape((L,) + v.shape[1:])

    def expand_cam(x):
        flat = x.reshape(C, -1)
        out = jnp.einsum("co,ck->ok", onehot, flat, precision=_ONEHOT_PREC)
        return out.reshape((O,) + x.shape[1:])

    def gather_lm(v):
        return v[jnp.clip(lm_sorted, 0, L - 1)]

    return SegOps(seg_cam=seg_cam, seg_lm=seg_lm, expand_cam=expand_cam,
                  gather_lm=gather_lm)


def _sort_obs_by_landmark(state: "SparseBAState") -> "SparseBAState":
    """Reorder the observation arrays ascending by landmark id, masked rows
    last.  The (cam, lm, uv, mask) tuples are preserved as a set, so the
    problem is unchanged; four [O]-row gathers, once per BA call."""
    L = state.num_landmarks
    order = jnp.argsort(
        jnp.where(state.obs_mask, jnp.clip(state.lm_idx, 0, L - 1), L)
    )
    return state.replace(
        cam_idx=state.cam_idx[order],
        lm_idx=state.lm_idx[order],
        uv=state.uv[order],
        obs_mask=state.obs_mask[order],
    )


def _use_sorted_layout(config: BAConfig) -> bool:
    """'scatter' takes ``segment_sum``; 'sorted' the scatter-free forms."""
    if config.obs_layout not in ("scatter", "sorted"):
        raise ValueError(f"unknown obs_layout {config.obs_layout!r}")
    return config.obs_layout == "sorted"


@struct.dataclass
class SparseBAState:
    """BA problem as flat observation lists (padded + masked)."""

    poses: Pose               # [C] world→camera
    X: Array                  # [L, 3]
    cam_idx: Array            # [O] int32 camera per observation
    lm_idx: Array             # [O] int32 landmark per observation
    uv: Array                 # [O, 2] measurements
    obs_mask: Array           # [O] validity
    cam_fixed: Array          # [C] bool — gauge-fixed cameras
    lm_fixed: Array           # [L] bool — held-constant landmarks: their
                              # observations still constrain cameras (the U
                              # term — PnP-like absolute anchors) but they
                              # are excluded from the Schur elimination and
                              # receive no update (implemented by zeroing
                              # their V⁻¹ rows, which makes dl exactly 0)

    @property
    def num_cameras(self) -> int:
        return self.poses.t.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.X.shape[0]

    @property
    def num_observations(self) -> int:
        return self.uv.shape[0]


def make_sparse_ba_state(
    poses: Pose,
    X: Array,
    cam_idx: Array,
    lm_idx: Array,
    uv: Array,
    obs_mask: Array,
    num_fixed_cameras: int = 1,
) -> SparseBAState:
    C = poses.t.shape[0]
    return SparseBAState(
        poses=poses,
        X=X,
        cam_idx=cam_idx.astype(jnp.int32),
        lm_idx=lm_idx.astype(jnp.int32),
        uv=uv,
        obs_mask=obs_mask.astype(bool),
        cam_fixed=jnp.arange(C) < num_fixed_cameras,
        lm_fixed=jnp.zeros((X.shape[0],), bool),
    )


def _gathered(state: SparseBAState, ops: Optional[SegOps] = None):
    """Per-obs camera/landmark parameters: clip-indexed gathers by default,
    the SegOps expansion forms when a sorted layout is active."""
    c = jnp.clip(state.cam_idx, 0, state.num_cameras - 1)
    l = jnp.clip(state.lm_idx, 0, state.num_landmarks - 1)
    if ops is None:
        R = state.poses.R[c]
        t = state.poses.t[c]
        Xo = state.X[l]
    else:
        R = ops.expand_cam(state.poses.R)
        t = ops.expand_cam(state.poses.t)
        Xo = ops.gather_lm(state.X)
    return c, l, R, t, Xo


def sparse_residuals(
    state: SparseBAState, K: CameraIntrinsics,
    ops: Optional[SegOps] = None,
) -> Array:
    """Masked per-observation residuals [O, 2] (invalid → 0)."""
    _, _, R, t, Xo = _gathered(state, ops)
    xc = jnp.sum(R * Xo[:, None, :], axis=2) + t          # [O, 3]
    z = jnp.maximum(xc[:, 2], 1e-6)
    r = jnp.stack([
        K.fx * xc[:, 0] / z + K.cx - state.uv[:, 0],
        K.fy * xc[:, 1] / z + K.cy - state.uv[:, 1],
    ], axis=-1)
    return jnp.where(state.obs_mask[:, None], r, 0.0)


def sparse_residuals_and_jacobians(
    state: SparseBAState, K: CameraIntrinsics,
    ops: Optional[SegOps] = None,
) -> Tuple[Array, Array, Array]:
    """Per-observation residuals and ANALYTIC Jacobians.

    Returns r [O, 2], Jc [O, 2, 6], Jl [O, 2, 3] (masked rows zeroed).

    Closed forms instead of the vmapped ``jacfwd`` chain (the forward
    tangents re-ran the se3_exp/projection graph per column; the analytic
    form is a handful of [O]-wide elementwise passes).  With x = R·X + t,
    z' = max(z, ε),
    and the LEFT-multiplicative pose tangent (v, w) used by
    ``_residual_one`` (x(δ) = exp([w]×)·x + V·v):

        Jproj = [[fx/z', 0, −fx·x/z'²·𝟙(z>ε)],
                 [0, fy/z', −fy·y/z'²·𝟙(z>ε)]]
        ∂r/∂v = Jproj          ∂r/∂w = x crossed with each Jproj row
        ∂r/∂X = Jproj · R

    (row·(−[x]×) = x × row).  Parity with the jacfwd reference is tested
    in tests/test_sparse_ba.py.
    """
    _, _, R, t, Xo = _gathered(state, ops)
    xc = jnp.sum(R * Xo[:, None, :], axis=2) + t          # [O, 3]
    eps = 1e-6
    z = jnp.maximum(xc[:, 2], eps)
    inv = 1.0 / z
    u = xc[:, 0] * inv
    v = xc[:, 1] * inv
    fx, fy = K.fx, K.fy
    r = jnp.stack([fx * u + K.cx - state.uv[:, 0],
                   fy * v + K.cy - state.uv[:, 1]], axis=-1)

    live = (xc[:, 2] > eps).astype(xc.dtype)
    zero = jnp.zeros_like(inv)
    # Jproj rows [O, 2, 3]
    Jp = jnp.stack([
        jnp.stack([fx * inv, zero, -fx * u * inv * live], axis=-1),
        jnp.stack([zero, fy * inv, -fy * v * inv * live], axis=-1),
    ], axis=1)
    # ∂r/∂w = Jproj·(−[x]×); row a ↦ a·(−[x]×) = x × a
    Jw = jnp.cross(xc[:, None, :], Jp)                    # [O, 2, 3]
    Jc = jnp.concatenate([Jp, Jw], axis=-1)               # [O, 2, 6]
    Jl = jnp.sum(Jp[:, :, :, None] * R[:, None, :, :], axis=2)  # [O, 2, 3]

    m = state.obs_mask[:, None]
    return (
        jnp.where(m, r, 0.0),
        jnp.where(m[..., None], Jc, 0.0),
        jnp.where(m[..., None], Jl, 0.0),
    )


def _sparse_residuals_and_jacobians_jacfwd(
    state: SparseBAState, K: CameraIntrinsics,
    ops: Optional[SegOps] = None,
) -> Tuple[Array, Array, Array]:
    """vmapped-jacfwd reference implementation (kept as the parity oracle
    for the analytic forms above)."""
    _, _, R, t, Xo = _gathered(state, ops)
    z6 = jnp.zeros((6,), state.X.dtype)
    z3 = jnp.zeros((3,), state.X.dtype)

    def one(Ri, ti, Xi, uvi):
        f = lambda dp, dl: _residual_one(dp, dl, Ri, ti, Xi, uvi, K)
        return f(z6, z3), jax.jacfwd(f, 0)(z6, z3), jax.jacfwd(f, 1)(z6, z3)

    r, Jc, Jl = jax.vmap(one)(R, t, Xo, state.uv)
    m = state.obs_mask[:, None]
    return (
        jnp.where(m, r, 0.0),
        jnp.where(m[..., None], Jc, 0.0),
        jnp.where(m[..., None], Jl, 0.0),
    )


class SparseNormalEq(NamedTuple):
    """Normal-equation blocks in observation-list form.

    The coupling W stays per-observation ([O, 6, 3]) — the [C, L] grid is
    never formed; Schur products contract it with two segment-sums.
    """

    U: Array        # [C, 6, 6]
    V: Array        # [L, 3, 3]
    Wo: Array       # [O, 6, 3] per-observation coupling Jcᵀ w Jl
    bc: Array       # [C, 6]
    bl: Array       # [L, 3]
    cam: Array      # [O] clipped camera index
    lm: Array       # [O] clipped landmark index


def build_sparse_normal_equations(
    state: SparseBAState,
    r: Array,
    Jc: Array,
    Jl: Array,
    weights: Array,
    axis_name: Optional[str] = None,
    ops: Optional[SegOps] = None,
) -> SparseNormalEq:
    """Segment-sum assembly of the GN blocks from observation lists.

    weights: [O] (robust IRLS × validity; 0 for invalid rows).
    With ``axis_name``, O is the per-device shard and U/V/bc/bl are psum'd
    to replicated; Wo/cam/lm remain the local shard.  ``ops`` selects the
    reduction strategy (default: scatter segment_sum).
    """
    C, L = state.num_cameras, state.num_landmarks
    cam = jnp.clip(state.cam_idx, 0, C - 1)
    lm = jnp.clip(state.lm_idx, 0, L - 1)
    if ops is None:
        ops = _scatter_ops(C, L, cam, lm)
    w = weights[:, None, None]

    # Per-observation products as broadcast outer sums over the residual
    # axis (k=2), NOT einsums: an [O]-batched k=2 einsum lowers to O
    # degenerate tiny matmuls; the broadcast form is ~3 elementwise passes
    # over [O, 36], is exact f32, and needs no matmul-precision handling.
    Jcw = Jc * w          # [O, 2, 6]
    Uo = (Jcw[:, 0, :, None] * Jc[:, 0, None, :]
          + Jcw[:, 1, :, None] * Jc[:, 1, None, :])    # [O, 6, 6]
    Jlw = Jl * w
    Vo = (Jlw[:, 0, :, None] * Jl[:, 0, None, :]
          + Jlw[:, 1, :, None] * Jl[:, 1, None, :])    # [O, 3, 3]
    Wo = (Jcw[:, 0, :, None] * Jl[:, 0, None, :]
          + Jcw[:, 1, :, None] * Jl[:, 1, None, :])    # [O, 6, 3]
    wr = r * weights[:, None]
    bco = -(Jc[:, 0] * wr[:, 0:1] + Jc[:, 1] * wr[:, 1:2])   # [O, 6]
    blo = -(Jl[:, 0] * wr[:, 0:1] + Jl[:, 1] * wr[:, 1:2])   # [O, 3]

    U = _preduce(ops.seg_cam(Uo), axis_name)
    V = _preduce(ops.seg_lm(Vo), axis_name)
    bc = _preduce(ops.seg_cam(bco), axis_name)
    bl = _preduce(ops.seg_lm(blo), axis_name)
    return SparseNormalEq(U=U, V=V, Wo=Wo, bc=bc, bl=bl, cam=cam, lm=lm)


def _eq_ops(eq: SparseNormalEq, ops: Optional[SegOps]) -> SegOps:
    if ops is not None:
        return ops
    return _scatter_ops(eq.U.shape[0], eq.V.shape[0], eq.cam, eq.lm)


def sparse_schur_matvec(
    eq: SparseNormalEq,
    Vinv: Array,
    lam: Array,
    x: Array,
    axis_name: Optional[str] = None,
    ops: Optional[SegOps] = None,
) -> Array:
    """Implicit S @ x = (U − W V⁻¹ Wᵀ) x via two segment-sums.  [C, 6].

    Distributed: x, U, Vinv are replicated; the two segment-sums reduce the
    local observation shard and psum to global ([L, 3] then [C, 6]) — the
    exact "local partial + psum" plan from the module docstring.
    """
    ops = _eq_ops(eq, ops)
    U = _damp(eq.U, lam)
    Ux = jnp.einsum("cij,cj->ci", U, x)
    # Broadcast mul-reduce forms below, not einsums: the [O]/[L]-batched
    # tiny contractions lower to degenerate batched matmuls (see
    # build_sparse_normal_equations) — the broadcast form is exact f32.
    # t_l = Σ_{o: lm(o)=l} W_oᵀ x_{cam(o)}
    Wtx = jnp.sum(eq.Wo * ops.expand_cam(x)[:, :, None], axis=1)  # [O, 3]
    t = _preduce(ops.seg_lm(Wtx), axis_name)                  # [L, 3]
    u = jnp.sum(Vinv * t[:, None, :], axis=2)                 # [L, 3]
    # y_c = Σ_{o: cam(o)=c} W_o u_{lm(o)}
    Wu = jnp.sum(eq.Wo * ops.gather_lm(u)[:, None, :], axis=2)  # [O, 6]
    y = _preduce(ops.seg_cam(Wu), axis_name)                  # [C, 6]
    return Ux - y


def _sparse_schur_prep(
    eq: SparseNormalEq, lam: Array, axis_name: Optional[str] = None,
    ops: Optional[SegOps] = None,
    lm_fixed: Optional[Array] = None,
):
    """Damped V⁻¹, reduced gradient g, and the Jacobi preconditioner
    (exact 6×6 diagonal blocks of S, one segment-sum).

    ``lm_fixed`` rows get V⁻¹ = 0, which removes them from the Schur
    elimination everywhere downstream (matvec, gradient, preconditioner,
    back-substitution) while their U-term camera constraints remain."""
    ops = _eq_ops(eq, ops)
    Vinv = _inv3(_damp(eq.V, lam))
    if lm_fixed is not None:
        Vinv = jnp.where(lm_fixed[:, None, None], 0.0, Vinv)
    # g = bc − W V⁻¹ bl  (broadcast forms — see sparse_schur_matvec)
    Vb = jnp.sum(Vinv * eq.bl[:, None, :], axis=2)          # [L, 3]
    WVb = jnp.sum(eq.Wo * ops.gather_lm(Vb)[:, None, :], axis=2)  # [O, 6]
    g = eq.bc - _preduce(ops.seg_cam(WVb), axis_name)
    # diag blocks: S_cc = U_c − Σ_{o: cam=c} W_o Vinv_{lm(o)} W_oᵀ
    Vv = ops.gather_lm(Vinv)                                # [O, 3, 3]
    WV = jnp.sum(eq.Wo[:, :, :, None] * Vv[:, None, :, :], axis=2)
    WVWo = jnp.sum(WV[:, :, None, :] * eq.Wo[:, None, :, :], axis=3)
    S_diag = _damp(eq.U, lam) - _preduce(ops.seg_cam(WVWo), axis_name)
    Minv = jnp.linalg.inv(S_diag)
    return Vinv, g, Minv


def solve_sparse_schur_pcg(
    eq: SparseNormalEq,
    lam: Array,
    iterations: int = 50,
    axis_name: Optional[str] = None,
    ops: Optional[SegOps] = None,
    lm_fixed: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Jacobi-preconditioned CG on the implicit reduced camera system +
    landmark back-substitution.  Returns (dc [C, 6], dl [L, 3];
    ``lm_fixed`` rows of dl are exactly 0).

    Distributed: the CG state (x, r, p — all [C, 6]) is replicated, so the
    dot products need no collective; only the two segment-sums inside each
    matvec psum.
    """
    ops = _eq_ops(eq, ops)
    Vinv, g, Minv = _sparse_schur_prep(eq, lam, axis_name, ops, lm_fixed)

    mv = lambda x: sparse_schur_matvec(eq, Vinv, lam, x, axis_name, ops)
    precond = lambda r: jnp.einsum("cij,cj->ci", Minv, r)

    x = jnp.zeros_like(g)
    r = g - mv(x)
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)

    def body(i, carry):
        x, r, p, rz = carry
        Ap = mv(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-12)
        p = z + beta * p
        return x, r, p, rz_new

    dc, r, p, rz = jax.lax.fori_loop(0, iterations, body, (x, r, p, rz))
    # back-substitute: dl = V⁻¹ (bl − Σ_{o: lm=l} W_oᵀ dc_{cam(o)})
    Wtdc = jnp.sum(eq.Wo * ops.expand_cam(dc)[:, :, None], axis=1)
    rhs = eq.bl - _preduce(ops.seg_lm(Wtdc), axis_name)
    dl = jnp.sum(Vinv * rhs[:, None, :], axis=2)
    return dc, dl


def sparse_ba_cost(
    state: SparseBAState,
    K: CameraIntrinsics,
    huber_delta: float = 0.0,
    axis_name: Optional[str] = None,
    ops: Optional[SegOps] = None,
) -> Array:
    r = sparse_residuals(state, K, ops)
    if huber_delta > 0:
        n = jnp.linalg.norm(r, axis=-1)
        per = jnp.where(
            n <= huber_delta, 0.5 * n**2, huber_delta * (n - 0.5 * huber_delta)
        )
    else:
        per = 0.5 * jnp.sum(r * r, axis=-1)
    return _preduce(jnp.sum(jnp.where(state.obs_mask, per, 0.0)), axis_name)


def _sparse_huber_weights(r: Array, delta: float) -> Array:
    if delta <= 0:
        return jnp.ones(r.shape[:-1], r.dtype)
    norm = jnp.linalg.norm(r, axis=-1)
    return jnp.where(norm <= delta, 1.0, delta / jnp.maximum(norm, 1e-12))


class SparseLMStats(NamedTuple):
    iterations: Array
    initial_cost: Array
    final_cost: Array
    lam: Array


def _apply_update(state: SparseBAState, dc: Array, dl: Array) -> SparseBAState:
    dc = jnp.where(state.cam_fixed[:, None], 0.0, dc)
    Rd, td = se3_exp(dc)
    newR = Rd @ state.poses.R
    newt = jnp.einsum("cij,cj->ci", Rd, state.poses.t) + td
    return state.replace(poses=Pose(R=newR, t=newt), X=state.X + dl)


@f32_matmuls
def _bundle_adjust_sparse_impl(
    state: SparseBAState,
    K: CameraIntrinsics,
    config: BAConfig,
    axis_name: Optional[str] = None,
) -> Tuple[SparseBAState, SparseLMStats]:
    """LM loop body shared by the single-device jit and the shard_map'd
    distributed path (``axis_name`` set ⇒ per-observation arrays are the
    local shard; poses/X/stats replicated).

    With ``config.obs_layout='sorted'`` the observation arrays are
    sorted by landmark ONCE here and every reduction in the loop uses the
    scatter-free SegOps forms; the returned state carries the CALLER's
    original observation ordering (only poses/X change).  Under shard_map
    the sort is per-shard — each shard's local observations reorder, the
    psum-completed sums are unchanged.
    """
    orig_state = state
    if _use_sorted_layout(config):
        state = _sort_obs_by_landmark(state)
        ops = _sorted_ops(
            state.num_cameras, state.num_landmarks,
            jnp.clip(state.cam_idx, 0, state.num_cameras - 1),
            state.lm_idx, state.obs_mask,
        )
    else:
        ops = None
    cost0 = sparse_ba_cost(state, K, config.huber_delta, axis_name, ops)

    def step(carry):
        state, lam, cost, it, done = carry
        r, Jc, Jl = sparse_residuals_and_jacobians(state, K, ops)
        w = _sparse_huber_weights(r, config.huber_delta)
        w = w * state.obs_mask.astype(r.dtype)
        eq = build_sparse_normal_equations(
            state, r, Jc, Jl, w, axis_name, ops
        )
        dc, dl = solve_sparse_schur_pcg(
            eq, lam, config.pcg_iterations, axis_name, ops,
            lm_fixed=state.lm_fixed,
        )

        new_state = _apply_update(state, dc, dl)
        new_cost = sparse_ba_cost(
            new_state, K, config.huber_delta, axis_name, ops
        )
        accept = new_cost < cost

        state = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), new_state, state
        )
        cost_next = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam * config.damping_down, lam * config.damping_up)
        lam = jnp.clip(lam, 1e-10, 1e6)
        rel = jnp.abs(cost - cost_next) / jnp.maximum(cost, 1e-12)
        done = jnp.logical_and(accept, rel < config.rtol)
        return state, lam, cost_next, it + 1, done

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_and(it < config.max_iterations, jnp.logical_not(done))

    lam0 = jnp.asarray(config.damping_init, jnp.float32)
    state, lam, cost, it, _ = jax.lax.while_loop(
        cond, step, (state, lam0, cost0, jnp.asarray(0), jnp.asarray(False))
    )
    # hand back the caller's observation ordering (only poses/X changed)
    state = orig_state.replace(poses=state.poses, X=state.X)
    return state, SparseLMStats(
        iterations=it, initial_cost=cost0, final_cost=cost, lam=lam
    )


@partial(jax.jit, static_argnames=("config",))
def bundle_adjust_sparse(
    state: SparseBAState,
    K: CameraIntrinsics,
    config: BAConfig = BAConfig(),
) -> Tuple[SparseBAState, SparseLMStats]:
    """LM on observation lists — same contract as ``ba.lm.bundle_adjust``
    (monotone cost, whole loop one jit region) at O(O) memory.

    Solver is always the implicit-Schur PCG (``config.pcg_iterations``);
    a dense Cholesky would need the [C6, C6] S this layout avoids.
    """
    return _bundle_adjust_sparse_impl(state, K, config, axis_name=None)
