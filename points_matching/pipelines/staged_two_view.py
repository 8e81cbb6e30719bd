"""The two-view pipeline as REAL GPipe stages (SURVEY.md §2.3 P3).

Splits ``two_view_pipeline`` (the reference demo's detect → describe →
match → geometry flow, ``Points Matching/main.cpp:23-98``) into four stage
functions over one padded **wire pytree**, so microbatches of image pairs
stream through a device pipeline (``parallel.pipeline.pipeline_stages``)
instead of toy lambdas.

Wire design: every stage maps the wire to itself (same static shapes —
mandatory under jit), so the wire is the padded union of all stage
signatures.  Fields a stage has not produced yet ride through as zeros;
masks are int32 (not bool) and the PRNG key is raw uint32[2] so every leaf
survives the pipeline harness's psum-based output replication.  Binary
(ORB/Hamming) configs ride the same wire with uint32 bit-packed descriptor
leaves — the harness's select-then-psum replication is dtype-agnostic
(VERDICT r2 item 9).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

from points_matching.core.config import TwoViewConfig
from points_matching.core.types import Descriptors, Keypoints
from points_matching.geometry.fundamental import epipolar_residual_audit
from points_matching.geometry.ransac import ransac_fundamental
from points_matching.ops.descriptors import extract_descriptors
from points_matching.ops.detect import detect_keypoints
from points_matching.ops.matching import match_descriptors

Array = jax.Array
Wire = Dict[str, Array]

_SURF_DIM = 64
_ORB_WORDS = 8  # 256 bits packed into uint32 words


def _desc_leaf_spec(config: TwoViewConfig):
    """(shape-tail, dtype) of the wire's descriptor leaves per config."""
    if config.descriptor.kind == "surf":
        return (_SURF_DIM,), jnp.float32
    if config.descriptor.kind == "orb":
        return (_ORB_WORDS,), jnp.uint32
    raise ValueError(
        f"staged two-view wire: unknown descriptor kind "
        f"{config.descriptor.kind!r}"
    )


def two_view_wire(images1: Array, images2: Array, keys: Array,
                  config: TwoViewConfig) -> Wire:
    """Build the initial wire for a microbatch stream.

    Args:
      images1, images2: [M, H, W] float32 grayscale (0-255).
      keys: [M, 2] uint32 raw PRNG key data (one key per pair).
    Returns the wire pytree with leading microbatch dim M.
    """
    d_tail, d_dtype = _desc_leaf_spec(config)
    M = images1.shape[0]
    K = config.detector.max_keypoints
    zf = lambda *s: jnp.zeros((M,) + s, jnp.float32)
    zi = lambda *s: jnp.zeros((M,) + s, jnp.int32)
    wire: Wire = {
        "img1": images1.astype(jnp.float32),
        "img2": images2.astype(jnp.float32),
        "key": keys.astype(jnp.uint32),
    }
    for i in ("1", "2"):
        wire[f"xy{i}"] = zf(K, 2)
        wire[f"scale{i}"] = zf(K)
        wire[f"angle{i}"] = zf(K)
        wire[f"kmask{i}"] = zi(K)
        wire[f"desc{i}"] = jnp.zeros((M, K) + d_tail, d_dtype)
    wire["p1"] = zf(K, 2)
    wire["p2"] = zf(K, 2)
    wire["mmask"] = zi(K)
    wire["F"] = zf(3, 3)
    wire["num_inliers"] = zi()
    wire["residual_mean"] = zf()
    return wire


def _wire_kps(w: Wire, i: str) -> Keypoints:
    return Keypoints(
        xy=w[f"xy{i}"], scale=w[f"scale{i}"], angle=w[f"angle{i}"],
        score=jnp.zeros_like(w[f"scale{i}"]),
        mask=w[f"kmask{i}"] != 0,
    )


def two_view_stage_fns(config: TwoViewConfig) -> List[Callable[[Wire], Wire]]:
    """The four stage functions: detect → describe → match → geometry."""

    def s_detect(w: Wire) -> Wire:
        out = dict(w)
        for i, img in (("1", w["img1"]), ("2", w["img2"])):
            kps = detect_keypoints(img, config.detector)
            out[f"xy{i}"] = kps.xy
            out[f"scale{i}"] = kps.scale
            out[f"angle{i}"] = kps.angle
            out[f"kmask{i}"] = kps.mask.astype(jnp.int32)
        return out

    def s_describe(w: Wire) -> Wire:
        out = dict(w)
        for i, img in (("1", w["img1"]), ("2", w["img2"])):
            desc = extract_descriptors(img, _wire_kps(w, i), config.descriptor)
            out[f"desc{i}"] = desc.data
        return out

    binary = config.descriptor.kind == "orb"

    def s_match(w: Wire) -> Wire:
        out = dict(w)
        d1 = Descriptors(data=w["desc1"], mask=w["kmask1"] != 0, binary=binary)
        d2 = Descriptors(data=w["desc2"], mask=w["kmask2"] != 0, binary=binary)
        matches = match_descriptors(d1, d2, config.matcher)
        p1, p2 = matches.gather_points(_wire_kps(w, "1"), _wire_kps(w, "2"))
        out["p1"], out["p2"] = p1, p2
        out["mmask"] = matches.mask.astype(jnp.int32)
        return out

    def s_geometry(w: Wire) -> Wire:
        out = dict(w)
        mask = w["mmask"] != 0
        est = ransac_fundamental(w["key"], w["p1"], w["p2"], mask,
                                 config.ransac)
        _, res_mean = epipolar_residual_audit(est.F, w["p1"], w["p2"], mask,
                                              form="reference")
        out["F"] = est.F
        out["num_inliers"] = est.num_inliers.astype(jnp.int32)
        out["residual_mean"] = res_mean
        return out

    return [s_detect, s_describe, s_match, s_geometry]


def staged_two_view(images1: Array, images2: Array, keys: Array,
                    config: TwoViewConfig, mesh=None) -> Wire:
    """Run a microbatch of pairs through the 4-stage device pipeline.

    With ``mesh=None`` stages compose sequentially on one device (identical
    numerics — the parity oracle for the pipelined path).
    """
    from points_matching.parallel.pipeline import pipeline_stages

    wire = two_view_wire(images1, images2, keys, config)
    return pipeline_stages(two_view_stage_fns(config), wire, mesh=mesh)
