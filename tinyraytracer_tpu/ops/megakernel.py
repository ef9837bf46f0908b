"""The full path-tracing megakernel: a whole sampler in one GPU kernel.

This is what the reference's Metal backend was *going* to be
(sampler/metal/shader/kernel.metal:35-91 only ever traced one segment and
wrote a debug color): the complete pipeline — jittered camera ray
generation (pointgen.rs:38-51 + camera.rs:58-66), counter RNG, closest hit
over all primitives, material scatter (material/*), emission/background
accumulation (sampler/cpu.rs:47-62) and the sample mean (imager.rs:46-51) —
fused into ONE Pallas kernel launch per image, lowered through Triton.

Why: the modular XLA path (ops/trace.py) runs a `lax.scan` over the bounce
budget for every sample round; each step writes the wavefront's carry to
device memory, materializes (R, N) candidate matrices and issues several
launches. Here a ray lives in registers for its *entire life*: device
memory traffic is one pixel-id read and one (3,) color write per pixel —
per image.

Layout: each program owns BLOCK pixels (a _TILE_W x BLOCK/_TILE_W screen
tile, so neighbouring lanes trace coherent paths). Per-lane state is a set
of (BLOCK,) vectors. Each lane owns its own (sample, bounce) cursor: the
moment its path dies it folds the sample into its accumulator and starts
its next camera ray, so a lane pays ~ spp x mean path length rather than
spp x (longest path in its block).

Scene access: primitives are read from global memory in a loop inside the
kernel, one scalar load per field broadcast to every lane; there is no
scene-size ceiling. The loop keeps (best t, winner row) per lane; the
winner's shading payload is gathered by row index after the loop.

Numerics follow the modular path op for op (same pcg4d streams as
ops/rng.py, the `exact` intersection formulas of ops/intersect.py, the
scatter math of ops/scatter.py) and keep every reference semantic:
near-then-far sphere roots, half-open quad bounds, no background term when
the bounce budget runs out. On the CPU (interpret mode) images agree with
the modular renderer to float rounding; on the GPU, FMA contraction and the
device's sqrt/division/transcendental lowering differ from XLA's by ulps,
which can flip individual path decisions, so agreement there is
statistical. Gradients use the modular path, whose selection+recompute
structure autodiffs.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tinyraytracer_tpu.models import materials as mat
from tinyraytracer_tpu.models.camera import Camera
from tinyraytracer_tpu.models.world import SceneArrays

# Pixels per program (a power of two, as Triton requires) and the width of
# the screen tile they cover.
BLOCK = 128
_TILE_W = 16
NUM_WARPS = 4

_T_MIN = 1.0e-3      # sampler/cpu.rs:48
_MISS = 3.0e38
_TWO_PI = 6.283185307179586
_INV_2_24 = float(1.0 / (1 << 24))

# Field counts of the flat scene tables (see compact_scene).
_SPH_FIELDS = 4      # cx, cy, cz, r^2
_QUAD_FIELDS = 12    # n (3), n.corner, av (3), corner.av, bv (3), corner.bv
_PAY_FIELDS = 16     # is_quad, normal source (3), kind, albedo (3), fuzz,
#                      ior, emission (3), 3 pad


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KernelScene:
    """Valid primitives only, as flat f32 tables the kernel indexes.

    Spheres first, then quads, each in scene storage order, so the
    kernel's first-minimum winner is the dense argmin's winner. Quad plane
    quantities are precomputed on the host from the concrete scene (the
    kernel is forward-only; rebuild per scene like the BVH).
    """

    sph: jax.Array    # (max(ns, 1) * _SPH_FIELDS,)
    quad: jax.Array   # (max(nq, 1) * _QUAD_FIELDS,)
    pay: jax.Array    # (max(ns + nq, 1) * _PAY_FIELDS,)
    n_sph: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_quad: int = dataclasses.field(metadata=dict(static=True), default=0)


def compact_scene(scene: SceneArrays) -> KernelScene:
    """Host-side lowering of a SceneArrays into the kernel's tables."""
    sv = np.asarray(scene.sph_valid, bool)
    qv = np.asarray(scene.quad_valid, bool)
    s_idx = np.nonzero(sv)[0]
    q_idx = np.nonzero(qv)[0]
    ns, nq = len(s_idx), len(q_idx)

    sc = np.asarray(scene.sph_center, np.float32)[s_idx]
    sr = np.asarray(scene.sph_radius, np.float32)[s_idx]
    sph = np.zeros((max(ns, 1), _SPH_FIELDS), np.float32)
    sph[:ns, 0:3] = sc
    sph[:ns, 3] = sr ** 2

    corner = np.asarray(scene.quad_corner, np.float32)[q_idx]
    u = np.asarray(scene.quad_u, np.float32)[q_idx]
    v = np.asarray(scene.quad_v, np.float32)[q_idx]
    n = np.cross(u, v)
    nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    av = np.cross(v, n) / nn
    bv = np.cross(n, u) / nn
    quad = np.zeros((max(nq, 1), _QUAD_FIELDS), np.float32)
    quad[:nq, 0:3] = n
    quad[:nq, 3] = (n * corner).sum(-1)
    quad[:nq, 4:7] = av
    quad[:nq, 7] = (corner * av).sum(-1)
    quad[:nq, 8:11] = bv
    quad[:nq, 11] = (corner * bv).sum(-1)

    # Shading payload, one row per primitive. The normal source is the
    # sphere center (normal = p - c) or the quad's unit plane normal.
    pay = np.zeros((max(ns + nq, 1), _PAY_FIELDS), np.float32)
    pay[:ns, 1:4] = sc
    nlen = np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    pay[ns:ns + nq, 0] = 1.0
    pay[ns:ns + nq, 1:4] = n / nlen
    mat_id = np.concatenate([np.asarray(scene.sph_mat)[s_idx],
                             np.asarray(scene.quad_mat)[q_idx]]).astype(int)
    pay[:ns + nq, 4] = np.asarray(scene.mat_kind)[mat_id]
    pay[:ns + nq, 5:8] = np.asarray(scene.mat_albedo)[mat_id]
    pay[:ns + nq, 8] = np.asarray(scene.mat_fuzz)[mat_id]
    pay[:ns + nq, 9] = np.asarray(scene.mat_ior)[mat_id]
    pay[:ns + nq, 10:13] = np.asarray(scene.mat_emit)[mat_id]
    return KernelScene(
        sph=jnp.asarray(sph.reshape(-1)),
        quad=jnp.asarray(quad.reshape(-1)),
        pay=jnp.asarray(pay.reshape(-1)),
        n_sph=ns,
        n_quad=nq,
    )


def used_kind_flags(scene: SceneArrays) -> tuple:
    """(has_met, has_die): does any VALID primitive use a Metal /
    Dielectric material? Static scene facts that let the kernel compile
    out the absent scatter chains (see _shade_bounce) — a material merely
    registered but unused by live geometry doesn't count."""
    kinds = np.asarray(scene.mat_kind)
    sv = np.asarray(scene.sph_valid)
    qv = np.asarray(scene.quad_valid)
    uk = np.concatenate([kinds[np.asarray(scene.sph_mat)[sv]],
                         kinds[np.asarray(scene.quad_mat)[qv]]])
    return bool((uk == mat.METAL).any()), bool((uk == mat.DIELECTRIC).any())


# --- in-kernel counter RNG: identical streams to ops/rng.py ----------------

def _pcg4d(a, b, c, d):
    mul = jnp.uint32(1664525)
    add = jnp.uint32(1013904223)
    x = a * mul + add
    y = b * mul + add
    z = c * mul + add
    w = d * mul + add
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


def _uniform(bits):
    # Top 24 bits; the value fits in 24 bits, so the i32 hop is exact.
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(
        jnp.float32) * _INV_2_24


def _uniform4(pid, sample, stream, seed):
    x, y, z, w = _pcg4d(pid, sample, stream, seed)
    return _uniform(x), _uniform(y), _uniform(z), _uniform(w)


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def _shade_bounce(ox, oy, oz, dx, dy, dz,
                  thr_r, thr_g, thr_b, col_r, col_g, col_b,
                  alive, best_t, hit,
                  w_isq, w_ax, w_ay, w_az, w_kind,
                  w_ar, w_ag, w_ab, w_fuzz, w_ior, w_er, w_eg, w_eb,
                  u1, u2, u3, u4, bg_r, bg_g, bg_b,
                  has_met=True, has_die=True,
                  bg2_r=None, bg2_g=None, bg2_b=None):
    """One bounce's shading given the winner payload (cpu.rs:47-62).

    `w_a*` is the normal source: the quad's unit plane normal when
    `w_isq > 0.5`, the sphere center otherwise (hittable/mod.rs:34-40 does
    the face flip here). `u1..u4` are this bounce's scatter uniforms.
    Returns the post-bounce (o, d, throughput, color, alive_f) state.

    `has_met`/`has_die` are STATIC scene facts (does any valid primitive
    use a Metal / Dielectric material?). When False, that kind's scatter
    math is compiled out entirely. This is exactly value-preserving: the
    skipped results are consumed only through `is_met`/`is_die` winner
    selects, which can never be taken when no primitive carries that kind
    — lanes whose winner is a Light keep whatever the remaining chain
    yields, but their direction is discarded by the `scat` gate below.
    Scenes like the Cornell box (lambertian + light only) drop the whole
    reflect/refract/Schlick chain per bounce.
    """
    hit_live = alive & hit
    miss_live = alive & ~hit

    t = jnp.where(hit, best_t, 1.0)
    p_x = ox + t * dx
    p_y = oy + t * dy
    p_z = oz + t * dz
    # outward normal: quad -> unit plane normal, sphere -> p - c
    onx = jnp.where(w_isq > 0.5, w_ax, p_x - w_ax)
    ony = jnp.where(w_isq > 0.5, w_ay, p_y - w_ay)
    onz = jnp.where(w_isq > 0.5, w_az, p_z - w_az)
    onx, ony, onz = _normalize3(onx, ony, onz)
    # hittable/mod.rs:34-40 face flip
    front = (dx * onx + dy * ony + dz * onz) < 0.0
    sgn = jnp.where(front, 1.0, -1.0)
    nx_ = onx * sgn
    ny_ = ony * sgn
    nz_ = onz * sgn

    # cpu.rs:58-60 miss -> background; cpu.rs:49-50 emission.
    # Gradient sky (see _camera_vector): lerp bottom->top on the unit
    # miss direction's y.
    if bg2_r is not None:
        tmix = 0.5 * (dy + 1.0)
        bg_r = bg_r + tmix * (bg2_r - bg_r)
        bg_g = bg_g + tmix * (bg2_g - bg_g)
        bg_b = bg_b + tmix * (bg2_b - bg_b)
    mlf = miss_live.astype(jnp.float32)
    hlf = hit_live.astype(jnp.float32)
    col_r = col_r + mlf * thr_r * bg_r + hlf * thr_r * w_er
    col_g = col_g + mlf * thr_g * bg_g + hlf * thr_g * w_eg
    col_b = col_b + mlf * thr_b * bg_b + hlf * thr_b * w_eb

    # uniform in unit ball, inverse CDF (vec3extend.rs:15-30)
    theta = _TWO_PI * u1
    cphi = 1.0 - 2.0 * u2
    sphi = jnp.sqrt(jnp.maximum(0.0, 1.0 - cphi * cphi))
    # ops/rng.py cbrt: exp(log/3)
    rr = jnp.exp(jnp.log(jnp.maximum(u3, 1e-30)) * (1.0 / 3.0))
    bx = rr * sphi * jnp.cos(theta)
    by = rr * sphi * jnp.sin(theta)
    bz = rr * cphi
    bnorm = jax.lax.rsqrt(jnp.maximum(bx * bx + by * by + bz * bz, 1e-30))
    ux_ = bx * bnorm
    uy_ = by * bnorm
    uz_ = bz * bnorm

    # Lambertian (lambertian.rs:16-22)
    lx = nx_ + ux_
    ly = ny_ + uy_
    lz = nz_ + uz_
    degen = (jnp.abs(lx) < 1e-7) & (jnp.abs(ly) < 1e-7) & (jnp.abs(lz) < 1e-7)
    lx = jnp.where(degen, nx_, lx)
    ly = jnp.where(degen, ny_, ly)
    lz = jnp.where(degen, nz_, lz)

    if has_met or has_die:
        # shared reflection (metal.rs:18-25 / dielectric reflect branch)
        ddn = dx * nx_ + dy * ny_ + dz * nz_
        rx = dx - 2.0 * ddn * nx_
        ry = dy - 2.0 * ddn * ny_
        rz = dz - 2.0 * ddn * nz_
    if has_met:
        # Metal fuzz (metal.rs:18-25)
        mx = rx + w_fuzz * bx
        my = ry + w_fuzz * by
        mz = rz + w_fuzz * bz
    if has_die:
        # Dielectric (dielectric.rs:26-46)
        eta = jnp.where(front, 1.0 / w_ior, w_ior)
        cos = jnp.minimum(-(nx_ * dx + ny_ * dy + nz_ * dz), 1.0)
        sin = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos * cos))
        tir = eta * sin > 1.0
        sr0 = (1.0 - eta) / (1.0 + eta)
        r0 = sr0 * sr0
        refl = r0 + (1.0 - r0) * (1.0 - cos) ** 5
        choose_reflect = tir | (refl > u4)
        # refract (vec3extend.rs:79-84)
        px_ = eta * (dx + nx_ * cos)
        py2 = eta * (dy + ny_ * cos)
        pz_ = eta * (dz + nz_ * cos)
        plen2 = px_ * px_ + py2 * py2 + pz_ * pz_
        # Same 1e-12 floor as ops/scatter.py refract.
        par = -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - plen2), 1e-12))
        fx = px_ + par * nx_
        fy = py2 + par * ny_
        fz = pz_ + par * nz_
        gx = jnp.where(choose_reflect, rx, fx)
        gy = jnp.where(choose_reflect, ry, fy)
        gz = jnp.where(choose_reflect, rz, fz)

    # winner-kind select over whichever kinds exist in the scene; an
    # absent kind's branch can never win, so dropping it from the chain
    # is value-identical on every reachable lane
    is_lam = w_kind < 0.5
    if has_met and has_die:
        is_met = (w_kind >= 0.5) & (w_kind < 1.5)
        sx = jnp.where(is_lam, lx, jnp.where(is_met, mx, gx))
        sy = jnp.where(is_lam, ly, jnp.where(is_met, my, gy))
        sz = jnp.where(is_lam, lz, jnp.where(is_met, mz, gz))
    elif has_met:
        sx = jnp.where(is_lam, lx, mx)
        sy = jnp.where(is_lam, ly, my)
        sz = jnp.where(is_lam, lz, mz)
    elif has_die:
        sx = jnp.where(is_lam, lx, gx)
        sy = jnp.where(is_lam, ly, gy)
        sz = jnp.where(is_lam, lz, gz)
    else:
        sx, sy, sz = lx, ly, lz
    sx, sy, sz = _normalize3(sx, sy, sz)

    absorbed = w_kind >= 2.5          # LIGHT = 3
    scat = hit_live & ~absorbed
    sf = scat.astype(jnp.float32)
    inv_sf = 1.0 - sf
    thr_r = thr_r * (inv_sf + sf * w_ar)
    thr_g = thr_g * (inv_sf + sf * w_ag)
    thr_b = thr_b * (inv_sf + sf * w_ab)
    ox = jnp.where(scat, p_x, ox)
    oy = jnp.where(scat, p_y, oy)
    oz = jnp.where(scat, p_z, oz)
    dx = jnp.where(scat, sx, dx)
    dy = jnp.where(scat, sy, dy)
    dz = jnp.where(scat, sz, dz)
    return (ox, oy, oz, dx, dy, dz,
            thr_r, thr_g, thr_b, col_r, col_g, col_b, sf)


def _make_kernel(*, spp: int, max_bounces: int, width: int, n_sph: int,
                 n_quad: int, has_met: bool, has_die: bool, sky: bool):
    """Kernel body specialized on its static configuration.

    An absent primitive kind's loop is compiled out (the Cornell box runs
    no sphere code); `has_met`/`has_die` do the same for the material
    scatter chains (see _shade_bounce).
    """
    fspp = float(spp)
    fmb = float(max_bounces)

    def kernel(cam_ref, ctl_ref, pid_ref, sph_ref, quad_ref, pay_ref,
               out_ref):
        pid = pid_ref[...]                                   # (B,) i32
        pid_u = pid.astype(jnp.uint32)
        px = jax.lax.rem(pid, jnp.int32(width)).astype(jnp.float32)
        py = jax.lax.div(pid, jnp.int32(width)).astype(jnp.float32)

        def cam(i):
            return cam_ref[i]

        pos_x, pos_y, pos_z = cam(0), cam(1), cam(2)
        ul_x, ul_y, ul_z = cam(3), cam(4), cam(5)
        hx, hy, hz = cam(6), cam(7), cam(8)
        vx, vy, vz = cam(9), cam(10), cam(11)
        dux, duy, duz = cam(12), cam(13), cam(14)
        dvx, dvy, dvz = cam(15), cam(16), cam(17)
        inv_w1, inv_h1 = cam(18), cam(19)
        bg_r, bg_g, bg_b = cam(20), cam(21), cam(22)
        bg2_r, bg2_g, bg2_b = (
            (cam(24), cam(25), cam(26)) if sky else (None, None, None))
        seed = ctl_ref[0]
        spp_offset = ctl_ref[1]

        def gen_camera_ray(sample_id):
            """Camera ray for per-lane u32 `sample_id` (camera.py)."""
            r1, r2_, r3, r4 = _uniform4(pid_u, sample_id, jnp.uint32(0),
                                        seed)
            # pointgen.rs:41-42 (w-1)/(h-1) normalization
            u = (px + r1) * inv_w1
            v = (py + r2_) * inv_h1
            # defocus disk, polar form (math/vec3extend.rs:45-53)
            rad = jnp.sqrt(r3)
            th = _TWO_PI * r4
            ox = pos_x + rad * jnp.cos(th) * dux + rad * jnp.sin(th) * dvx
            oy = pos_y + rad * jnp.cos(th) * duy + rad * jnp.sin(th) * dvy
            oz = pos_z + rad * jnp.cos(th) * duz + rad * jnp.sin(th) * dvz
            tx = ul_x + u * hx - v * vx - ox
            ty = ul_y + u * hy - v * vy - oy
            tz = ul_z + u * hz - v * vz - oz
            dx, dy, dz = _normalize3(tx, ty, tz)   # ray.rs:13
            return ox, oy, oz, dx, dy, dz

        def closest_hit(ox, oy, oz, dx, dy, dz):
            """-> (best t, winner row) per lane; best t == _MISS on a miss.
            Strict `<` keeps the first minimum, i.e. the dense argmin."""
            best = jnp.full(ox.shape, _MISS, jnp.float32)
            row = jnp.zeros(ox.shape, jnp.int32)

            def sphere(k, st):
                best, row = st
                base = k * _SPH_FIELDS
                ocx = ox - sph_ref[base]
                ocy = oy - sph_ref[base + 1]
                ocz = oz - sph_ref[base + 2]
                half_b = ocx * dx + ocy * dy + ocz * dz
                c_term = ocx * ocx + ocy * ocy + ocz * ocz - sph_ref[base + 3]
                disc = half_b * half_b - c_term
                sq = jnp.sqrt(jnp.maximum(disc, 0.0))
                t0 = -half_b - sq
                t1 = -half_b + sq
                ts = jnp.where(t0 >= _T_MIN, t0,
                               jnp.where(t1 >= _T_MIN, t1, _MISS))
                ts = jnp.where(disc >= 0.0, ts, _MISS)
                upd = ts < best
                return jnp.where(upd, ts, best), jnp.where(upd, k, row)

            def quad(k, st):
                best, row = st
                base = k * _QUAD_FIELDS

                def f(i):
                    return quad_ref[base + i]

                den = f(0) * dx + f(1) * dy + f(2) * dz
                # grazing-ray validity guard (ops/intersect.py quad_ts)
                ok_den = jnp.abs(den) >= 1e-12
                den = jnp.where(ok_den, den, 1e-12)
                tq = (f(3) - (f(0) * ox + f(1) * oy + f(2) * oz)) / den
                al = (f(4) * ox + f(5) * oy + f(6) * oz) + tq * (
                    f(4) * dx + f(5) * dy + f(6) * dz) - f(7)
                be = (f(8) * ox + f(9) * oy + f(10) * oz) + tq * (
                    f(8) * dx + f(9) * dy + f(10) * dz) - f(11)
                ok = (ok_den & (tq >= _T_MIN)
                      & (al >= 0.0) & (al < 1.0) & (be >= 0.0) & (be < 1.0))
                ts = jnp.where(ok, tq, _MISS)
                upd = ts < best
                return (jnp.where(upd, ts, best),
                        jnp.where(upd, n_sph + k, row))

            st = (best, row)
            if n_sph:
                st = jax.lax.fori_loop(0, n_sph, sphere, st)
            if n_quad:
                st = jax.lax.fori_loop(0, n_quad, quad, st)
            return st

        def bounce_step(sample_id, bctr, st):
            """One bounce (cpu.rs:47-62) for every live lane."""
            (ox, oy, oz, dx, dy, dz,
             thr_r, thr_g, thr_b, col_r, col_g, col_b, alive_f) = st
            alive = alive_f > 0.5
            best_t, row = closest_hit(ox, oy, oz, dx, dy, dz)
            hit = best_t < _MISS
            base = row * _PAY_FIELDS

            def w(i):
                return pay_ref[base + i]

            # scatter randomness: stream 1 + bounce (ops/scatter.py)
            u1, u2, u3, u4 = _uniform4(pid_u, sample_id,
                                       jnp.uint32(1) + bctr, seed)
            return _shade_bounce(
                ox, oy, oz, dx, dy, dz,
                thr_r, thr_g, thr_b, col_r, col_g, col_b,
                alive, best_t, hit,
                w(0), w(1), w(2), w(3), w(4),
                w(5), w(6), w(7), w(8), w(9), w(10), w(11), w(12),
                u1, u2, u3, u4, bg_r, bg_g, bg_b,
                has_met=has_met, has_die=has_die,
                bg2_r=bg2_r, bg2_g=bg2_g, bg2_b=bg2_b)

        def loop_cond(st):
            return jnp.min(st[0]) < fspp

        def loop_body(st):
            (samp_f, bnc_f, ox, oy, oz, dx, dy, dz,
             thr_r, thr_g, thr_b, col_r, col_g, col_b,
             acc_r, acc_g, acc_b, alive_f) = st

            # fold the finished sample, start the next one (per lane)
            need = alive_f < 0.5
            acc_r = jnp.where(need, acc_r + col_r, acc_r)
            acc_g = jnp.where(need, acc_g + col_g, acc_g)
            acc_b = jnp.where(need, acc_b + col_b, acc_b)
            samp_f = jnp.where(need, samp_f + 1.0, samp_f)
            start = need & (samp_f < fspp)
            # f32 -> i32 -> u32: sample counters stay < 2^24, exact
            samp_u = spp_offset + jnp.maximum(samp_f, 0.0).astype(
                jnp.int32).astype(jnp.uint32)
            gox, goy, goz, gdx, gdy, gdz = gen_camera_ray(samp_u)
            ox = jnp.where(start, gox, ox)
            oy = jnp.where(start, goy, oy)
            oz = jnp.where(start, goz, oz)
            dx = jnp.where(start, gdx, dx)
            dy = jnp.where(start, gdy, dy)
            dz = jnp.where(start, gdz, dz)
            col_r = jnp.where(need, 0.0, col_r)
            col_g = jnp.where(need, 0.0, col_g)
            col_b = jnp.where(need, 0.0, col_b)
            thr_r = jnp.where(start, 1.0, thr_r)
            thr_g = jnp.where(start, 1.0, thr_g)
            thr_b = jnp.where(start, 1.0, thr_b)
            bnc_f = jnp.where(start, 0.0, bnc_f)
            alive_f = jnp.where(start, 1.0, alive_f)

            # one bounce for whoever is live
            was_alive = alive_f
            bctr = bnc_f.astype(jnp.int32).astype(jnp.uint32)
            (ox, oy, oz, dx, dy, dz,
             thr_r, thr_g, thr_b, col_r, col_g, col_b,
             alive_f) = bounce_step(
                samp_u, bctr,
                (ox, oy, oz, dx, dy, dz,
                 thr_r, thr_g, thr_b, col_r, col_g, col_b, alive_f))
            # budget exhaustion kills with NO background add (cpu.rs:47-62)
            bnc_f = bnc_f + was_alive
            alive_f = jnp.where(bnc_f < fmb, alive_f, 0.0)
            return (samp_f, bnc_f, ox, oy, oz, dx, dy, dz,
                    thr_r, thr_g, thr_b, col_r, col_g, col_b,
                    acc_r, acc_g, acc_b, alive_f)

        z = jnp.zeros(px.shape, jnp.float32)
        one = z + 1.0
        st0 = (
            z - 1.0,              # sample cursor: before the first
            z,                    # bounce counter
            z, z, z,              # origin (generated on entry)
            z, z, one,            # direction (inert +z)
            one, one, one,        # throughput
            z, z, z,              # sample color
            z, z, z,              # accumulator
            z,                    # dead -> start a sample
        )
        st = jax.lax.while_loop(loop_cond, loop_body, st0)
        inv = 1.0 / fspp
        out_ref[0, :] = st[14] * inv
        out_ref[1, :] = st[15] * inv
        out_ref[2, :] = st[16] * inv

    return kernel


def _camera_vector(camera: Camera, background) -> jnp.ndarray:
    """(32,) camera/config vector. `background` is (3,) constant or
    (2, 3) [bottom, top] gradient sky (lerped on the unit miss direction's
    y). Slots 20:23 = bottom, 24:27 = top."""
    cam = np.zeros((32,), np.float32)
    cam[0:3] = np.asarray(camera.position)
    cam[3:6] = np.asarray(camera.viewport_upper_left)
    cam[6:9] = np.asarray(camera.horizontal)
    cam[9:12] = np.asarray(camera.vertical)
    cam[12:15] = np.asarray(camera.defocus_disk_u)
    cam[15:18] = np.asarray(camera.defocus_disk_v)
    cam[18] = 1.0 / max(camera.width - 1, 1)
    cam[19] = 1.0 / max(camera.height - 1, 1)
    bg = np.asarray(background, np.float32)
    if bg.shape == (2, 3):
        cam[20:23] = bg[0]
        cam[24:27] = bg[1]
    else:
        cam[20:23] = bg
        cam[24:27] = bg
    return jnp.asarray(cam)


@functools.lru_cache(maxsize=32)
def block_pixel_ids(width: int, height: int, n_shards: int = 1):
    """Pixel ids in program order: program i traces the i-th
    _TILE_W x (BLOCK/_TILE_W) screen tile, row-major over tiles.

    Returns (pid (RP,) i32, inv (npix,) i32): `inv` maps a pixel id to its
    first position in `pid`. Edge tiles, and the extra tiles that make the
    tile count a multiple of `n_shards`, repeat clamped pixels; RNG keys
    on the pixel id alone, so a repeat recomputes the same value. numpy
    only: jnp constants made here would leak tracers when this cache is
    hit from inside another jit trace."""
    bh = BLOCK // _TILE_W
    nbx = -(-width // _TILE_W)
    nby = -(-height // bh)
    nblk = -(-(nbx * nby) // n_shards) * n_shards
    i = np.arange(nblk * BLOCK)
    blk, lane = i // BLOCK, i % BLOCK
    x = np.minimum((blk % nbx) * _TILE_W + lane % _TILE_W, width - 1)
    y = np.minimum((blk // nbx) * bh + lane // _TILE_W, height - 1)
    pid = (y * width + x).astype(np.int32)
    inv = np.zeros(width * height, np.int32)
    inv[pid[::-1]] = np.arange(pid.size - 1, -1, -1, dtype=np.int32)
    return pid, inv


def _run_kernel(ks: KernelScene, cam_vec, ctl, pid, *, spp, max_bounces,
                width, has_met, has_die, sky, interpret):
    """pallas_call over block-ordered pixel ids (RP,); returns (3, RP)."""
    rp = pid.shape[0]
    kernel = _make_kernel(spp=spp, max_bounces=max_bounces, width=width,
                          n_sph=ks.n_sph, n_quad=ks.n_quad,
                          has_met=has_met, has_die=has_die, sky=sky)
    whole = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=(rp // BLOCK,),
        in_specs=[
            whole, whole,
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            whole, whole, whole,
        ],
        out_specs=pl.BlockSpec((3, BLOCK), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((3, rp), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="path_trace_megakernel",
    )(cam_vec, ctl, pid, ks.sph, ks.quad, ks.pay)


@functools.partial(
    jax.jit,
    static_argnames=("spp", "max_bounces", "width", "height", "mesh",
                     "has_met", "has_die", "sky", "interpret"),
)
def _render(ks: KernelScene, cam_vec, ctl, *, spp: int, max_bounces: int,
            width: int, height: int, mesh=None, has_met: bool = True,
            has_die: bool = True, sky: bool = False,
            interpret: bool = False):
    """(H, W, 3) mean radiance; over `mesh` (tile x sample) when given:
    pixel tiles shard over "tile", spp splits over "sample" with a pmean
    (the scene tables replicate; the kernel runs per shard)."""
    kw = dict(max_bounces=max_bounces, width=width, has_met=has_met,
              has_die=has_die, sky=sky, interpret=interpret)
    if mesh is None:
        pid, inv = block_pixel_ids(width, height)
        color = _run_kernel(ks, cam_vec, ctl, jnp.asarray(pid), spp=spp,
                            **kw)
    else:
        from jax.sharding import PartitionSpec as P

        from tinyraytracer_tpu.parallel.sharded import SAMPLE_AXIS, TILE_AXIS

        n_sample = mesh.shape[SAMPLE_AXIS]
        if spp % n_sample:
            raise ValueError(
                f"spp={spp} not divisible by sample axis {n_sample}")
        spp_local = spp // n_sample
        pid, inv = block_pixel_ids(width, height, mesh.shape[TILE_AXIS])

        def body(ks, cam_vec, ctl, pid):
            s_idx = jax.lax.axis_index(SAMPLE_AXIS).astype(jnp.uint32)
            ctl = ctl.at[1].add(s_idx * jnp.uint32(spp_local))
            color = _run_kernel(ks, cam_vec, ctl, pid, spp=spp_local, **kw)
            if n_sample == 1:
                return color
            return jax.lax.pmean(color, SAMPLE_AXIS)

        color = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(), P(TILE_AXIS)),
            out_specs=P(None, TILE_AXIS),
            check_vma=False,
        )(ks, cam_vec, ctl, jnp.asarray(pid))
    return jnp.take(color, jnp.asarray(inv), axis=1).T.reshape(
        height, width, 3)


class MegakernelRenderer:
    """Scene-bound forward renderer (one kernel launch per image).

    `interpret=True` runs the kernel through the Pallas interpreter, which
    is how it is tested on the CPU; without it the kernel compiles for the
    GPU through Triton.
    """

    def __init__(self, scene: SceneArrays, camera: Camera, background,
                 interpret: bool = False):
        self.scene = scene
        self.camera = camera
        self.ks = compact_scene(scene)
        if not (self.ks.n_sph or self.ks.n_quad):
            raise ValueError("scene has no primitives")
        self.has_met, self.has_die = used_kind_flags(scene)
        self.cam_vec = _camera_vector(camera, background)
        self.sky = np.asarray(background, np.float32).shape == (2, 3)
        self.interpret = bool(interpret)
        self._burst = None     # (key, jitted fn) cache for render_burst

    def render(self, *, spp: int, max_bounces: int, seed: int = 0,
               spp_offset: int = 0, mesh=None) -> jax.Array:
        """(H, W, 3) mean radiance over samples [spp_offset, +spp)."""
        ctl = jnp.asarray([seed, spp_offset, 0, 0], jnp.uint32)
        return _render(
            self.ks, self.cam_vec, ctl,
            spp=spp, max_bounces=max_bounces,
            width=self.camera.width, height=self.camera.height, mesh=mesh,
            has_met=self.has_met, has_die=self.has_die, sky=self.sky,
            interpret=self.interpret)

    def render_burst(self, *, spp: int, max_bounces: int,
                     seeds) -> jax.Array:
        """len(seeds) independent renders in ONE XLA program -> (n,H,W,3).

        Small frames are dispatch-bound: baking N seed-renders into one
        compiled program pays the host dispatch once for N images (the
        analog of the reference batching 10,240 rays per Metal dispatch,
        sampler.rs:11). Each frame equals the single render of its seed."""
        seeds = tuple(int(s) for s in seeds)
        key = (spp, max_bounces, seeds)
        if self._burst is None or self._burst[0] != key:
            fn = jax.jit(lambda: jnp.stack([
                self.render(spp=spp, max_bounces=max_bounces, seed=s)
                for s in seeds]))
            self._burst = (key, fn)
        return self._burst[1]()


def render_image_megakernel(
    scene: SceneArrays,
    camera: Camera,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed: int = 0,
    interpret: bool = False,
):
    """One-shot megakernel render. Returns (H, W, 3) linear radiance."""
    r = MegakernelRenderer(scene, camera, background, interpret=interpret)
    return r.render(spp=spp, max_bounces=max_bounces, seed=seed)
