"""Counter-based, placement-invariant RNG for the path tracer.

The reference uses an unseedable thread-local RNG (utils/random.rs:11-18),
which makes renders non-deterministic. Here every random draw is a pure
function of (seed, pixel_id, sample_id, stream): a PCG4D hash (Jarzynski &
Olano, "Hash Functions for GPU Rendering", JCGT 2020): fully vectorized u32
arithmetic, no sequential state (the same streams run inside the GPU
megakernel, ops/megakernel.py), and
*placement-invariant* — resharding rays across a device mesh can never change
the image, because randomness depends only on logical ray coordinates.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32
# 2^-24: map the top 24 bits of a u32 to [0, 1).
_INV_2_24 = jnp.float32(1.0 / (1 << 24))


def pcg4d(a, b, c, d):
    """PCG4D hash: four u32 counters -> four decorrelated u32 words.

    Inputs broadcast against each other; all arithmetic is mod 2^32.
    """
    x = jnp.asarray(a, _U32)
    y = jnp.asarray(b, _U32)
    z = jnp.asarray(c, _U32)
    w = jnp.asarray(d, _U32)

    mul = _U32(1664525)
    add = _U32(1013904223)
    x = x * mul + add
    y = y * mul + add
    z = z * mul + add
    w = w * mul + add

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_uniform(bits):
    """u32 -> f32 uniform in [0, 1) using the top 24 bits (exact in f32)."""
    return (bits >> _U32(8)).astype(jnp.float32) * _INV_2_24


def uniform4(seed, pixel_id, sample_id, stream):
    """Four independent uniforms in [0,1) per (seed, pixel, sample, stream).

    ``pixel_id``/``sample_id``/``stream`` may be arrays (they broadcast).
    Replaces utils/random.rs:11-18 with a seedable, deterministic source.
    """
    x, y, z, w = pcg4d(pixel_id, sample_id, stream, seed)
    return _to_uniform(x), _to_uniform(y), _to_uniform(z), _to_uniform(w)


def cbrt(x):
    """x^(1/3) for x >= 0 via exp(log(x)/3).

    Chosen over jnp.cbrt so the Pallas megakernel (ops/megakernel.py, which
    spells it the same way) and the modular path draw the same scatter
    directions.
    """
    return jnp.exp(jnp.log(jnp.maximum(x, 1e-30)) * (1.0 / 3.0))


def uniform_in_unit_sphere(u1, u2, u3):
    """Uniform point in the unit ball via inverse CDF.

    Same parameterization as the reference (math/vec3extend.rs:15-30):
    theta = 2*pi*u1, phi = acos(1 - 2*u2), r = cbrt(u3).
    Returns an (..., 3) array.
    """
    theta = (2.0 * jnp.pi) * u1
    cos_phi = 1.0 - 2.0 * u2
    sin_phi = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_phi * cos_phi))
    r = cbrt(u3)
    x = r * sin_phi * jnp.cos(theta)
    y = r * sin_phi * jnp.sin(theta)
    z = r * cos_phi
    return jnp.stack([x, y, z], axis=-1)


def uniform_unit_vector(u1, u2):
    """Uniform direction on the unit sphere.

    The reference normalizes a uniform-in-ball sample
    (math/vec3extend.rs:32-34); the resulting distribution is exactly uniform
    on the sphere, which this computes directly (r = 1), saving one uniform.
    """
    theta = (2.0 * jnp.pi) * u1
    cos_phi = 1.0 - 2.0 * u2
    sin_phi = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_phi * cos_phi))
    x = sin_phi * jnp.cos(theta)
    y = sin_phi * jnp.sin(theta)
    z = cos_phi
    return jnp.stack([x, y, z], axis=-1)


def uniform_in_unit_disk(u1, u2):
    """Uniform point in the unit disk, polar form.

    The reference rejection-samples (math/vec3extend.rs:45-53); rejection
    loops don't vectorize, and the polar map r = sqrt(u), theta = 2*pi*u
    yields the identical distribution. Returns (..., 2)."""
    r = jnp.sqrt(u1)
    theta = (2.0 * jnp.pi) * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
