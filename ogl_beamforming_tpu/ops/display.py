"""Display mapping and frame reductions.

Covers the reference's Sum / MinMax shaders (shaders/sum.glsl,
shaders/min_max.glsl — dormant in the reference planner,
beamformer_core.c:491-496, but part of the component inventory) and the
fragment-shader display transfer function (render_3d.frag.glsl:61-70).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def sum_frames(frames: jax.Array, scale=None) -> jax.Array:
    """Average a stack of frames (sum.glsl semantics: out += scale * in)."""
    n = frames.shape[0]
    if scale is None:
        scale = 1.0 / n
    return frames.sum(axis=0) * scale


@jax.jit
def min_max(volume: jax.Array):
    """Global min/max of |volume| (min_max.glsl's reduction endpoint)."""
    mag = jnp.abs(volume)
    return mag.min(), mag.max()


@partial(jax.jit, static_argnames=())
def display_map(volume: jax.Array, db_cutoff=-60.0, threshold=1.0,
                gamma=1.0) -> jax.Array:
    """Normalize -> dB -> clamp -> threshold -> gamma
    (render_3d.frag.glsl:61-70).  Returns values in [0, 1]."""
    mag = jnp.abs(volume).astype(jnp.float32)
    peak = jnp.maximum(mag.max(), 1e-30)
    db = 20.0 * jnp.log10(jnp.maximum(mag / peak, 1e-30))
    db = jnp.clip(db, db_cutoff, 0.0)
    out = 1.0 - db / db_cutoff
    out = jnp.minimum(out, threshold)
    return jnp.power(out, gamma)
