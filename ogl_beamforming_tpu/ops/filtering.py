"""FIR filtering, demodulation, and Hilbert transform.

The reference implements these as a single workgroup-shared-memory GLSL
shader (shaders/filter.glsl) and an optional CUDA Hilbert plugin.  Here
the FIR is a tap-unrolled chain of strided multiply-adds that XLA fuses
into one elementwise kernel, or a strided ``conv_general_dilated`` for
long filters, and the Hilbert transform uses the FFT.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


_UNROLL_MAX_TAPS = 128
"""Tap count up to which the FIR unrolls into strided multiply-adds.

Unrolling keeps the whole FIR in one XLA elementwise fusion (exact f32,
no precision knob).  For the 16-tap Kaiser demodulate stage of the
demod->decode->DAS chain (int16 RF, 128 x 16 x 2048) it took 0.232 ms
against 0.406 ms for the single-channel ``conv_general_dilated`` at
``Precision.HIGHEST`` (H100 80GB HBM3, 700 W power limit; PERF.md).
Long filters (chirps) keep the conv.
"""


def _conv1d(x: jax.Array, taps: jax.Array, decimation_rate: int) -> jax.Array:
    """Real strided correlation with the reference's alignment.

    ``y[n] = sum_j x[D n - (L-1) + j] h[j]`` (filter.glsl:89-92,114-118):
    left-pad L-1 zeros, stride D, output length ``S // D``.
    """
    length = taps.shape[0]
    s = x.shape[-1]
    lead = x.shape[:-1]
    n_out = s // decimation_rate
    if length <= _UNROLL_MAX_TAPS:
        return _fir_unrolled(x, taps, decimation_rate, n_out)
    xb = x.reshape((-1, 1, s))
    out = jax.lax.conv_general_dilated(
        xb.astype(jnp.float32),
        taps.astype(jnp.float32).reshape(1, 1, length),
        window_strides=(decimation_rate,),
        padding=[(length - 1, decimation_rate)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # Convolutions may otherwise run at reduced precision (TF32 on
        # the GPU); the FIR stays full f32 to hold the 1e-3 NRMSE contract.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :n_out].reshape(lead + (n_out,))


def _fir_unrolled(x: jax.Array, taps: jax.Array, decimation_rate: int,
                  n_out: int) -> jax.Array:
    """Tap-unrolled strided FIR: ``y[n] = sum_j xpad[D n + j] h[j]`` with
    L-1 left zeros — the same alignment as the conv path, as L fused
    vector FMAs over strided slices."""
    length = taps.shape[0]
    d = decimation_rate
    pad = [(0, 0)] * (x.ndim - 1) + [(length - 1, d)]
    xp = jnp.pad(x.astype(jnp.float32), pad)
    h = taps.astype(jnp.float32)
    acc = None
    span = (n_out - 1) * d + 1
    for j in range(length):
        seg = jax.lax.slice_in_dim(xp, j, j + span, stride=d, axis=-1)
        term = h[j] * seg
        acc = term if acc is None else acc + term
    return acc


def fir_filter(rf: jax.Array, taps: jax.Array,
               decimation_rate: int = 1) -> jax.Array:
    """FIR along the last axis; complex data and/or taps supported.

    Matches :func:`..ops.golden.fir_filter`.
    """
    cx_x = jnp.iscomplexobj(rf)
    cx_h = jnp.iscomplexobj(taps)
    if not cx_x and not cx_h:
        return _conv1d(rf, taps, decimation_rate)
    if cx_x and not cx_h:
        return (_conv1d(rf.real, taps, decimation_rate)
                + 1j * _conv1d(rf.imag, taps, decimation_rate)
                ).astype(jnp.complex64)
    if not cx_x and cx_h:
        return (_conv1d(rf, taps.real, decimation_rate)
                + 1j * _conv1d(rf, taps.imag, decimation_rate)
                ).astype(jnp.complex64)
    rr = _conv1d(rf.real, taps.real, decimation_rate)
    ii = _conv1d(rf.imag, taps.imag, decimation_rate)
    ri = _conv1d(rf.real, taps.imag, decimation_rate)
    ir = _conv1d(rf.imag, taps.real, decimation_rate)
    return ((rr - ii) + 1j * (ri + ir)).astype(jnp.complex64)


@partial(jax.jit, static_argnames=("decimation_rate", "complex_filter"))
def demodulate(rf: jax.Array, taps: jax.Array, demodulation_frequency,
               sampling_frequency, decimation_rate: int = 1,
               complex_filter: bool = False) -> jax.Array:
    """Implicit-IQ demodulation + FIR decimation (filter.glsl:57-64,99-118).

    ``IQ[n] = RF[2n] - j RF[2n+1]`` at pair rate fs/2, rotated by
    ``exp(-j 2 pi f_d n / (fs/2))``, scaled sqrt(2) unless the filter is
    complex, then FIR-filtered with decimation.  Matches
    :func:`..ops.golden.demodulate`.
    """
    s_pairs = rf.shape[-1] // 2
    x = rf[..., : 2 * s_pairs].astype(jnp.float32)
    i = x[..., 0::2]
    q = x[..., 1::2]

    pair_fs = sampling_frequency / 2.0
    n = jnp.arange(s_pairs, dtype=jnp.float32)
    arg = (2 * jnp.pi * demodulation_frequency / pair_fs) * n
    c, s = jnp.cos(arg), jnp.sin(arg)
    scale = jnp.float32(1.0 if complex_filter else jnp.sqrt(2.0))
    # (i - j q) * (cos - j sin), scaled
    re = scale * (i * c - q * s)
    im = scale * (-q * c - i * s)
    iq = (re + 1j * im).astype(jnp.complex64)
    return fir_filter(iq, taps, decimation_rate).astype(jnp.complex64)


@jax.jit
def hilbert(rf: jax.Array) -> jax.Array:
    """Analytic signal along the last axis (FFT method).

    Replaces the reference's dlopen'd CUDA Hilbert plugin
    (beamformer_internal.h:225-252).
    """
    x = rf.astype(jnp.float32)
    n = x.shape[-1]
    xf = jnp.fft.fft(x, axis=-1)
    h = jnp.zeros(n, jnp.float32)
    if n % 2 == 0:
        h = h.at[0].set(1).at[n // 2].set(1).at[1:n // 2].set(2)
    else:
        h = h.at[0].set(1).at[1:(n + 1) // 2].set(2)
    return jnp.fft.ifft(xf * h, axis=-1).astype(jnp.complex64)
