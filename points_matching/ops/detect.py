"""Device-resident keypoint detection (implicit native component N1,
SURVEY.md §2.2 — the accelerator replacement for ``cv::SurfFeatureDetector``,
demo call site ``Points Matching/main.cpp:23-26``).

Design (per SURVEY.md §1.2):
  * the scale pyramid is a stack of *convolutions at full resolution* —
    Gaussian second-derivative (determinant-of-Hessian, SURF-class) or
    Harris/FAST corner responses — all expressed as ``lax.conv`` /
    ``reduce_window`` so XLA fuses them into dense passes;
  * non-max suppression is window-max comparison (no sequential scan);
  * the data-dependent "how many keypoints?" is resolved by a fixed-capacity
    ``top_k`` over the full response volume + a score/threshold mask —
    static shapes end-to-end (the SURVEY §7 masking discipline).

SURF's box-filter approximation exists to make CPU integral-image tricks
fast; on an accelerator exact Gaussian derivative filters are *cheaper*
(dense convs)
and better conditioned, so we use those — same capability, native idiom.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from points_matching.core.config import DetectorConfig
from points_matching.core.types import Keypoints


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(sigma: float, radius: int, order: int = 0):
    """1-D Gaussian (order 0), first (1) or second (2) derivative kernel.

    Returns a NUMPY array: the taps are trace-time constants, so the
    unrolled shift-FMA convolution below folds them into one fused XLA
    elementwise kernel instead of threading device scalars through it.
    """
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = g / np.sum(g)
    if order == 0:
        return g
    if order == 1:
        return (g * (-x / sigma**2)).astype(np.float32)
    if order == 2:
        return (g * ((x**2 - sigma**2) / sigma**4)).astype(np.float32)
    raise ValueError(order)


def _conv1d_axis(img: Array, k: np.ndarray, axis: int) -> Array:
    """SAME-zero-padded 1-D correlation along ``axis`` as an unrolled
    static-slice FMA chain.

    The taps as Σᵢ kᵢ·slice(pad(img))ᵢ are a pure elementwise DAG that
    XLA fuses into a handful of passes, in place of a single-channel
    ``lax.conv_general_dilated`` (N=C=1).  Identical math (correlation, no
    kernel flip — matching lax.conv's convention), identical SAME-zero
    edge behavior; only the f32 summation order differs.
    """
    n = len(k)
    R = (n - 1) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (R, R)
    p = jnp.pad(img, pad)
    H, W = img.shape
    acc = None
    for i in range(n):
        w = float(k[i])
        if w == 0.0:
            continue
        sl = (
            p[i:i + H, :] if axis == 0 else p[:, i:i + W]
        )
        term = w * sl
        acc = term if acc is None else acc + term
    if acc is None:
        acc = jnp.zeros_like(img)
    return acc


def _conv_sep(img: Array, ky: np.ndarray, kx: np.ndarray) -> Array:
    """Separable 2-D correlation of [H, W] with 1-D kernels (SAME padding,
    zero edges) — column pass then row pass, both as shift-FMA chains."""
    return _conv1d_axis(_conv1d_axis(img, np.asarray(ky), 0),
                        np.asarray(kx), 1)


def gaussian_blur(img: Array, sigma: float) -> Array:
    r = max(1, int(math.ceil(3.0 * sigma)))
    g = _gaussian_kernel1d(sigma, r, 0)
    return _conv_sep(img, g, g)


def hessian_response(img: Array, sigma: float) -> Array:
    """Scale-normalized determinant of Hessian at scale ``sigma``.

    σ⁴·(Lxx·Lyy − (0.9·Lxy)²) — the 0.9 factor mirrors SURF's box-filter
    weight (Bay et al.), keeping our threshold scale comparable.
    """
    r = max(1, int(math.ceil(3.0 * sigma)))
    g0 = _gaussian_kernel1d(sigma, r, 0)
    g1 = _gaussian_kernel1d(sigma, r, 1)
    g2 = _gaussian_kernel1d(sigma, r, 2)
    Lxx = _conv_sep(img, g0, g2)
    Lyy = _conv_sep(img, g2, g0)
    Lxy = _conv_sep(img, g1, g1)
    s4 = sigma**4
    return s4 * (Lxx * Lyy - (0.9 * Lxy) ** 2)


def harris_response(img: Array, sigma: float, k: float = 0.04) -> Array:
    """Harris corner response at integration scale ``sigma``."""
    gd = 0.7 * sigma
    r = max(1, int(math.ceil(3.0 * gd)))
    g0 = _gaussian_kernel1d(gd, r, 0)
    g1 = _gaussian_kernel1d(gd, r, 1)
    Ix = _conv_sep(img, g0, g1)
    Iy = _conv_sep(img, g1, g0)
    Sxx = gaussian_blur(Ix * Ix, sigma)
    Syy = gaussian_blur(Iy * Iy, sigma)
    Sxy = gaussian_blur(Ix * Iy, sigma)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    return sigma**2 * (det - k * tr * tr)


_FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def fast_response(img: Array, threshold: float, arc: int = 9) -> Array:
    """FAST-N corner score (N-contiguous-pixel arc on the 16-pixel ring).

    The sequential per-pixel arc test becomes a vectorized bit trick: shift
    the whole image by the 16 ring offsets (cheap pads), build brighter /
    darker bitmasks, and test for an N-run in the 16-bit ring word by ANDing
    N rotations.  Score = sum of |diff| over the qualifying ring pixels.
    """
    ring = []
    for dy, dx in _FAST_OFFSETS:
        ring.append(jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)))
    ring = jnp.stack(ring, axis=0)  # [16, H, W]

    diff = ring - img[None]
    brighter = diff > threshold
    darker = diff < -threshold

    def has_arc(bits: Array) -> Array:
        # bits: [16, H, W] bool; arc run of length `arc` (circular)
        acc = bits
        for s in range(1, arc):
            acc = jnp.logical_and(acc, jnp.roll(bits, -s, axis=0))
        return jnp.any(acc, axis=0)

    is_corner = jnp.logical_or(has_arc(brighter), has_arc(darker))
    score = jnp.sum(jnp.where(jnp.logical_or(brighter, darker), jnp.abs(diff), 0.0), axis=0)
    return jnp.where(is_corner, score, 0.0)


# ---------------------------------------------------------------------------
# Scale space + NMS + top-k
# ---------------------------------------------------------------------------

def detector_sigmas(config: DetectorConfig) -> Tuple[float, ...]:
    """Scale ladder: SURF-like geometric progression from σ₀ = 1.2."""
    sig = []
    for o in range(config.num_octaves):
        for l in range(config.layers_per_octave):
            sig.append(1.2 * (2.0 ** (o + l / config.layers_per_octave)))
    return tuple(sig)


def _spatial_nms(resp: Array, radius: int) -> Array:
    """True where resp equals the local max in a (2r+1)² window."""
    k = 2 * radius + 1
    mx = lax.reduce_window(
        resp, -jnp.inf, lax.max, (1, k, k), (1, 1, 1), "SAME"
    )
    return resp >= mx


def _scale_nms(resp: Array) -> Array:
    """True where resp is ≥ its scale neighbors (3-tap over scale axis 0)."""
    up = jnp.concatenate([resp[1:], jnp.full_like(resp[:1], -jnp.inf)], axis=0)
    dn = jnp.concatenate([jnp.full_like(resp[:1], -jnp.inf), resp[:-1]], axis=0)
    return jnp.logical_and(resp >= up, resp >= dn)


def _orientation(img: Array, xy: Array, scale: Array) -> Array:
    """Dominant orientation: Gaussian-weighted average gradient direction in
    a 6σ window (smooth analogue of SURF's Haar-sector vote,
    reference component N1)."""
    from points_matching.ops.sampling import bilinear_sample

    # fixed 13×13 sample lattice scaled by σ
    g = jnp.linspace(-1.0, 1.0, 13)
    gy, gx = jnp.meshgrid(g, g, indexing="ij")
    offs = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)  # [169, 2]
    w = jnp.exp(-0.5 * (offs[:, 0] ** 2 + offs[:, 1] ** 2) / 0.5**2)

    pts = xy[:, None, :] + 3.0 * scale[:, None, None] * offs[None]  # [N, 169, 2]
    eps = jnp.asarray([[1.0, 0.0]])
    epsy = jnp.asarray([[0.0, 1.0]])
    h = jnp.maximum(scale[:, None], 1.0)
    gx_s = (bilinear_sample(img, pts + eps * h[..., None]) -
            bilinear_sample(img, pts - eps * h[..., None]))
    gy_s = (bilinear_sample(img, pts + epsy * h[..., None]) -
            bilinear_sample(img, pts - epsy * h[..., None]))
    mx = jnp.sum(gx_s * w[None], axis=1)
    my = jnp.sum(gy_s * w[None], axis=1)
    return jnp.arctan2(my, mx)


def detect_keypoints(
    image: Array,
    config: DetectorConfig = DetectorConfig(),
) -> Keypoints:
    """Detect up to ``config.max_keypoints`` keypoints (padded + masked).

    Args:
      image: [H, W] float32 grayscale in [0, 255] (reference loads 8-bit
             images; we keep that value scale so thresholds transfer).

    Returns a fixed-capacity ``Keypoints``.
    """
    img = image.astype(jnp.float32)
    H, W = img.shape
    sigmas = detector_sigmas(config)

    if config.kind == "hessian":
        resp = jnp.stack([hessian_response(img, s) for s in sigmas], axis=0)
        thresh = config.threshold * 1e-4  # SURF box-filter units → DoH units
    elif config.kind == "harris":
        resp = jnp.stack([harris_response(img, s) for s in sigmas], axis=0)
        thresh = config.threshold
    elif config.kind == "fast":
        base = fast_response(img, config.threshold)
        resp = base[None]
        sigmas = (1.0,)
        thresh = 1e-6
    else:
        raise ValueError(f"unknown detector kind: {config.kind!r}")

    is_peak = jnp.logical_and(_spatial_nms(resp, config.nms_radius), _scale_nms(resp))

    # border + threshold mask
    yy = jnp.arange(H)[None, :, None]
    xx = jnp.arange(W)[None, None, :]
    b = config.border
    in_border = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    valid = is_peak & in_border & (resp > thresh)

    score_m = jnp.where(valid, resp, -jnp.inf)
    k = config.max_keypoints
    if config.nms_radius >= 1:
        # 4× shrink of the top-k candidate set before the sort: spatial
        # NMS with radius ≥ 1 means any two cells of a 2×2 block are
        # 8-neighbors, so for DISTINCT responses at most one peak
        # survives per block.  The one exception: the NMS compare is
        # non-strict (resp >= window max), so an exactly-tied adjacent
        # plateau lets multiple equal peaks through, and the per-block
        # max keeps one of them — deduplicating equal-score keypoints
        # 1 px apart, which is the desirable outcome (the full-volume
        # top_k kept all copies).
        #
        # The block max is a stride-2 reduce_window and the winning cell
        # is recovered AFTER top-k by gathering each winner's 4 cells,
        # instead of materializing a pad→reshape→transpose→argmax volume.
        S = score_m.shape[0]
        H2, W2 = -(-H // 2), -(-W // 2)
        p = jnp.pad(score_m, ((0, 0), (0, 2 * H2 - H), (0, 2 * W2 - W)),
                    constant_values=-jnp.inf)
        bmax = lax.reduce_window(
            p, -jnp.inf, lax.max, (1, 2, 2), (1, 2, 2), "VALID"
        )  # [S, H2, W2]
        # Exact top-k in two stages: per-scale batched top-k then a merge
        # of the S·k survivors — every global top-k element is in its own
        # scale's top-k, so the result set is identical to the flat sort
        # (the row-parallel [S, H2·W2] form parallelizes better than one
        # flat [S·H2·W2] sort).
        ts, ti = lax.top_k(bmax.reshape(S, -1), k)       # [S, k]
        top_scores, sel = lax.top_k(ts.reshape(-1), k)   # [k]
        s_idx = sel // k
        rem = ti.reshape(-1)[sel]                        # index in scale plane
        yb = rem // W2
        xb = rem % W2
        # which of the winner's 4 cells held the max — same (0,0),(0,1),
        # (1,0),(1,1) order and first-tie argmax as the old transposed
        # [..., 4] layout
        pf = p.reshape(-1)
        Wp = 2 * W2
        base = s_idx * (2 * H2 * Wp) + (2 * yb) * Wp + 2 * xb
        cells = jnp.stack(
            [pf[base], pf[base + 1], pf[base + Wp], pf[base + Wp + 1]],
            axis=-1,
        )  # [k, 4]
        la = jnp.argmax(cells, axis=-1).astype(jnp.int32)
        y_idx = yb * 2 + (la >> 1)
        x_idx = xb * 2 + (la & 1)
    else:
        top_scores, top_idx = lax.top_k(score_m.reshape(-1), k)
        s_idx = top_idx // (H * W)
        rem = top_idx % (H * W)
        y_idx = rem // W
        x_idx = rem % W

    # Per-winner sub-pixel offsets from the winner's 4 response neighbors
    # (4 gathers per winner instead of full-volume offset maps that would
    # produce k useful values).  Values are identical for interior winners — the
    # border mask (config.border ≥ nms_radius ≥ 1) keeps every VALID winner
    # ≥ 1 px from the image edge, where the old roll-wrap and this clip
    # agree; padded (invalid) rows differ only in masked-out lanes.
    rf = resp.reshape(-1)
    yc = jnp.clip(y_idx, 1, H - 2)
    xc = jnp.clip(x_idx, 1, W - 2)
    basec = s_idx * (H * W) + yc * W + xc
    cur = rf[basec]

    def _parab(prev, c, nxt):
        denom = prev - 2.0 * c + nxt
        off = 0.5 * (prev - nxt) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        return jnp.clip(off, -0.5, 0.5)

    dxv = _parab(rf[basec - 1], cur, rf[basec + 1])
    dyv = _parab(rf[basec - W], cur, rf[basec + W])

    xy = jnp.stack(
        [x_idx.astype(jnp.float32) + dxv, y_idx.astype(jnp.float32) + dyv], axis=-1
    )
    scale = jnp.asarray(sigmas, jnp.float32)[s_idx]
    mask = jnp.isfinite(top_scores)
    score = jnp.where(mask, top_scores, 0.0)

    if config.compute_orientation and config.kind != "fast":
        angle = _orientation(img, xy, scale)
    else:
        angle = jnp.zeros((k,), jnp.float32)

    return Keypoints(xy=xy, scale=scale, angle=angle, score=score, mask=mask)
