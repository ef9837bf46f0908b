"""Branchless material scatter.

The reference dispatches `Material::scatter` through trait objects per hit
(material/*.rs). Here every ray evaluates all four lobes with vector math
and selects by material kind — the classic wavefront formulation. All
semantics mirror the reference:

  - Lambertian: dir = normal + uniform unit vector, with fallback to the
    normal when the sum is near zero, |comp| < 1e-7 (lambertian.rs:16-22,
    vec3.rs:32-35);
  - Metal: dir = reflect(d, n) + fuzz * uniform-in-ball (metal.rs:18-25);
  - Dielectric: eta by front face, Schlick reflectance, TIR-or-probabilistic
    reflect vs refract, attenuation = albedo (dielectric.rs:26-46);
  - Light: absorbs — scatter is None (light.rs:17-19).

Returned directions are normalized (Ray::new normalizes, ray.rs:13).
"""

from __future__ import annotations

import jax.numpy as jnp

from tinyraytracer_tpu.models import materials as mat
from tinyraytracer_tpu.ops import rng
from tinyraytracer_tpu.ops.intersect import HitRecord


def _dot(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def reflect(d, n):
    """v - 2 (v.n) n (math/vec3extend.rs:75-77)."""
    return d - 2.0 * _dot(d, n) * n


def refract(d, n, eta):
    """Snell refraction with cos clamp (math/vec3extend.rs:79-84).

    eta: (R, 1) ratio etai/etat; d, n unit (R, 3). The sqrt argument is
    floored: at exact grazing incidence (|perp| -> 1) the derivative of
    sqrt(|1-x|) is infinite, and since every ray evaluates every material
    lobe before the select, that infinity would leak NaN into the backward
    pass of unrelated parameters (0-cotangent * inf)."""
    cos = jnp.minimum(-_dot(n, d), 1.0)
    perp = eta * (d + n * cos)
    k = jnp.abs(1.0 - jnp.sum(perp * perp, axis=-1, keepdims=True))
    parallel = -jnp.sqrt(jnp.maximum(k, 1e-12)) * n
    return parallel + perp


def _schlick(cos, eta):
    """Schlick reflectance with the reference's eta convention
    (dielectric.rs:16-22)."""
    sqrt_r0 = (1.0 - eta) / (1.0 + eta)
    r0 = sqrt_r0 * sqrt_r0
    return r0 + (1.0 - r0) * (1.0 - cos) ** 5


def scatter(d, rec: HitRecord, seed, pixel_id, sample_id, bounce):
    """Scatter a ray batch off its hit records.

    d: (R,3) incoming unit directions. Returns (new_dir (R,3) unit,
    attenuation (R,3), absorbed (R,) bool). Randomness is drawn from the
    counter-based stream (1 + bounce) so camera jitter (stream 0) and every
    bounce are decorrelated.
    """
    u1, u2, u3, u4 = rng.uniform4(seed, pixel_id, sample_id, bounce + jnp.uint32(1))
    in_ball = rng.uniform_in_unit_sphere(u1, u2, u3)            # (R,3)
    ball_norm = jnp.sqrt(
        jnp.maximum(jnp.sum(in_ball * in_ball, axis=-1, keepdims=True), 1e-24)
    )
    unit = in_ball / ball_norm                                  # uniform on sphere

    n = rec.normal

    # Lambertian (lambertian.rs:16-22)
    lam_dir = n + unit
    degenerate = jnp.all(jnp.abs(lam_dir) < 1e-7, axis=-1, keepdims=True)
    lam_dir = jnp.where(degenerate, n, lam_dir)

    # Metal (metal.rs:18-25) — fuzz scaled uniform-in-ball offset
    met_dir = reflect(d, n) + rec.fuzz[:, None] * in_ball

    # Dielectric (dielectric.rs:26-46)
    eta = jnp.where(rec.front_face, 1.0 / rec.ior, rec.ior)[:, None]  # (R,1)
    cos = jnp.minimum(-_dot(n, d), 1.0)
    sin = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos * cos))
    total_reflection = eta * sin > 1.0
    reflectance = _schlick(cos, eta)
    choose_reflect = total_reflection | (reflectance > u4[:, None])
    die_dir = jnp.where(choose_reflect, reflect(d, n), refract(d, n, eta))

    kind = rec.mat_kind[:, None]
    new_dir = jnp.where(
        kind == mat.LAMBERTIAN,
        lam_dir,
        jnp.where(kind == mat.METAL, met_dir, die_dir),
    )
    new_dir = new_dir / jnp.sqrt(
        jnp.maximum(jnp.sum(new_dir * new_dir, axis=-1, keepdims=True), 1e-24)
    )
    attenuation = rec.albedo
    absorbed = rec.mat_kind == mat.LIGHT
    return new_dir, attenuation, absorbed
