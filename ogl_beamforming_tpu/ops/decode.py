"""Hadamard decode.

Decode is one matrix product over the acquisition axis per frame —
``out[c, t, s] = sum_j H[t, j] rf[c, j, s] / T`` — which XLA hands to the
GPU's matrix library as a product batched over channels, written straight
into the (C, A, S) frame layout.  The reference does the same on tensor
cores (decode.glsl:76-117: f16 operands, f32 accumulation).

The precision is explicit: ``Precision.HIGHEST``.  A float32 product may
otherwise run as TF32, which keeps 10 mantissa bits and is exact only for
|x| <= 2048, while RF arrives as full-range int16.  At HIGHEST every
int16 product and every partial sum up to 2^24 is exact in float32, so the
decode is exact up to the final 1/T scale.  PERF.md holds the measurement
that chose it over a two-pass bf16 split.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.hadamard import hadamard as _hadamard_host


def hadamard_matrix(order: int, dtype=jnp.float32) -> jax.Array:
    """Device Hadamard matrix H (row-major, untransposed)."""
    return jnp.asarray(_hadamard_host(order), dtype=dtype)


def _decode_real(x: jax.Array, hadamard: jax.Array) -> jax.Array:
    c = x.shape[0]
    h = jnp.broadcast_to(hadamard.astype(jnp.float32),
                         (c,) + hadamard.shape)
    # batch c, contract H's columns with the acquisition axis: (C, A, S)
    y = jax.lax.dot_general(
        h, x.astype(jnp.float32), (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return y * jnp.float32(1.0 / hadamard.shape[0])


@jax.jit
def decode_hadamard(rf: jax.Array, hadamard: jax.Array) -> jax.Array:
    """Decode ``rf`` (C, A, S) with ``hadamard`` (A, A).

    Matches :func:`ogl_beamforming_tpu.ops.golden.decode_hadamard`
    (decode.glsl:120-150).  Complex input decodes re/im with the same
    product."""
    if jnp.iscomplexobj(rf):
        return jax.lax.complex(_decode_real(jnp.real(rf), hadamard),
                               _decode_real(jnp.imag(rf), hadamard))
    return _decode_real(rf, hadamard)
