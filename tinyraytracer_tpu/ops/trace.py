"""The wavefront bounce-loop megakernel and full-image render.

The reference's hot path is a per-sample recursive loop over BVH hits and
material scatters on CPU worker tasks (sampler/cpu.rs:39-65). Here the whole
ray batch advances together through a masked `lax.scan` over bounces — the
wavefront formulation — with semantics matched step for step:

  cpu.rs:47      bounce budget: exactly `max_bounces` hit+scatter iterations
  cpu.rs:48      hit t-range (1e-3, inf)
  cpu.rs:49-50   color += throughput * emission on *every* hit
  cpu.rs:52-54   scatter: throughput *= attenuation, ray = scattered ray
  cpu.rs:55-57   absorbed (scatter None, i.e. Light): ray dies
  cpu.rs:58-60   miss: color += throughput * background, ray dies
  (exhausting the budget adds NO background term — cpu.rs:47-62)

The scan is reverse-mode differentiable; `jax.checkpoint` on the body keeps
backward memory at one bounce of residuals (rematerialization trades device
memory for FLOPs).

Accumulation over samples (the Imager's mean, renderer/imager.rs:46-51) is a
`lax.scan` over sample rounds, so peak memory is one ray-wavefront regardless
of spp.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from tinyraytracer_tpu.models.camera import Camera, generate_rays
from tinyraytracer_tpu.models.world import SceneArrays
from tinyraytracer_tpu.ops import intersect as isect
from tinyraytracer_tpu.ops.scatter import scatter

# Rematerialization policy for the bounce scan: the detached winner/shadow
# *selections* (argmin / BVH walk — the expensive discrete
# part) are saved as per-bounce residuals, so the backward pass recomputes
# only the cheap differentiable shading chain. Without this, remat re-runs
# every selection pass a second time under the transpose.
_SAVE_SELECT = jax.checkpoint_policies.save_only_these_names("select")

# Target wavefront width (rays traced at once) when fusing samples; one
# wavefront's live state is ~30 (R,) f32 arrays, so 1M rays ~ 120 MB.
_FUSE_RAY_TARGET = 1 << 20


def trace(
    scene: SceneArrays,
    origins,
    directions,
    pixel_id,
    sample_id,
    seed,
    max_bounces: int,
    background,
    exact: bool = False,
    remat: bool = True,
    bvh=None,
    nee: bool = False,
    silhouette: bool = False,
    count_alive: bool = False,
):
    """Path-trace a ray wavefront. Returns (R, 3) linear radiance.

    `count_alive=True` additionally returns the per-bounce alive ray
    counts (max_bounces,) f32 — the path-length histogram's survival
    curve, from which mean_executed_bounces computes the mean number of
    bounce segments actually executed per camera ray.

    origins/directions: (R,3) with unit directions; pixel_id: (R,) u32;
    sample_id: scalar u32; background: (3,) f32.

    Intersector selection (both produce identical hits and gradients):
      - default: dense all-primitives test (XLA matmuls);
      - `bvh` (ops.bvh.BVHArrays): threaded BVH traversal — fewer
        intersections for big scenes.

    `nee=True` switches diffuse light transport to next-event estimation
    (explicit area sampling of quad lights, emission skipped on the
    subsequent diffuse-BSDF light hit to avoid double counting). Same
    expected image, far lower variance near small lights — and, crucially,
    the NEE contribution T·(albedo/pi)·E·cos_x·|cos_y|·A/r² is a *smooth*
    function of scene geometry, so `jax.grad` yields real gradients for
    sphere centers/radii and quad vectors. The default unidirectional
    estimator's per-sample radiance is a product of discretely-selected
    constants: geometry only moves discontinuity boundaries, and its
    pathwise gradient is exactly zero almost everywhere (the reference
    semantics are kept as the parity/default path; visibility-boundary
    terms remain unestimated under NEE — the standard detached-sampling
    bias).
    """
    r = origins.shape[0]
    background = jnp.asarray(background, jnp.float32)
    # The scan carry is kept as (R,) *components*: the carry is stored to
    # device memory every bounce — and, under remat, re-read by the
    # backward pass — and components keep every crossing at logical size
    # without a padded minor dimension; in-body (R, 3) temporaries are
    # free (XLA fuses them away).
    ones = jnp.ones((r,), jnp.float32)
    zeros = jnp.zeros((r,), jnp.float32)
    init = (
        origins[:, 0], origins[:, 1], origins[:, 2],
        directions[:, 0], directions[:, 1], directions[:, 2],
        ones, ones, ones,                # throughput rgb
        zeros, zeros, zeros,             # accumulated color rgb
        jnp.ones((r,), bool),            # alive (reached a scatter)
        jnp.zeros((r,), bool),           # previous bounce was diffuse (NEE)
    )

    def select(o, d):
        """Detached closest-hit selection: (t_screen, j). j < 0 = miss."""
        if bvh is not None:
            from tinyraytracer_tpu.ops.bvh import traverse

            return traverse(scene, bvh, o, d)
        return isect.closest_select(scene, o, d, exact=exact)

    def body(carry, bounce):
        (o_x, o_y, o_z, d_x, d_y, d_z, t_r, t_g, t_b, c_r, c_g, c_b,
         alive, prev_diffuse) = carry
        o = jnp.stack([o_x, o_y, o_z], axis=-1)
        d = jnp.stack([d_x, d_y, d_z], axis=-1)
        throughput = jnp.stack([t_r, t_g, t_b], axis=-1)
        color = jnp.stack([c_r, c_g, c_b], axis=-1)
        # Selection is detached and saved as a remat residual ("select"):
        # the backward pass reconstructs the record from the saved winner
        # instead of re-running the argmin / BVH walk.
        t_sel, j = checkpoint_name(select(o, d), "select")
        if silhouette:
            throughput = throughput * _silhouette_factor(
                scene, o, d, t_sel, j, alive
            )[:, None]
        rec = isect.select_to_record(scene, o, d, t_sel, j)

        hit_live = alive & rec.hit
        miss_live = alive & ~rec.hit

        # miss -> background, die (cpu.rs:58-60). A (2, 3) background is
        # the gradient sky [bottom, top], lerped on the unit miss
        # direction's y — the renderer.rs-snapshot's dropped capability
        # (cf. /root/reference/output.png's RTiOW sky).
        if background.ndim == 2:
            tmix = 0.5 * (d[:, 1:2] + 1.0)                   # (R, 1)
            bg_ray = background[0][None, :] + tmix * (
                background[1] - background[0])[None, :]
        else:
            bg_ray = background[None, :]
        color = color + jnp.where(
            miss_live[:, None], throughput * bg_ray, 0.0
        )
        # hit -> emission (cpu.rs:49-50). Under NEE the previous *diffuse*
        # bounce already accounted for direct light — but only from the
        # lights NEE samples (quad lights, _nee_contribution). Emission from
        # sphere-shaped lights must still be counted here or their diffuse
        # direct lighting is silently lost (biased darker).
        if nee:
            from tinyraytracer_tpu.models import materials as _mat

            nee_sampled = rec.is_quad & (rec.mat_kind == _mat.LIGHT)
            count_emit = hit_live & ~(prev_diffuse & nee_sampled)
        else:
            count_emit = hit_live
        color = color + jnp.where(count_emit[:, None], throughput * rec.emit, 0.0)

        if nee:
            color = color + _nee_contribution(
                scene, rec, hit_live, throughput, d,
                seed, pixel_id, sample_id, bounce, select,
            )

        new_d, attenuation, absorbed = scatter(
            d, rec, seed, pixel_id, sample_id, bounce
        )
        scattered = hit_live & ~absorbed
        throughput = jnp.where(scattered[:, None], throughput * attenuation, throughput)
        o = jnp.where(scattered[:, None], rec.point, o)
        d = jnp.where(scattered[:, None], new_d, d)
        alive = scattered
        from tinyraytracer_tpu.models import materials as mat

        prev_diffuse = scattered & (rec.mat_kind == mat.LAMBERTIAN)
        out = (
            o[:, 0], o[:, 1], o[:, 2],
            d[:, 0], d[:, 1], d[:, 2],
            throughput[:, 0], throughput[:, 1], throughput[:, 2],
            color[:, 0], color[:, 1], color[:, 2],
            alive, prev_diffuse,
        )
        return out, (jnp.sum(alive.astype(jnp.float32))
                     if count_alive else None)

    if remat:
        body = jax.checkpoint(body, policy=_SAVE_SELECT)
    bounces = jnp.arange(max_bounces, dtype=jnp.uint32)
    fin, ys = jax.lax.scan(body, init, bounces)
    colors = jnp.stack([fin[9], fin[10], fin[11]], axis=-1)
    if count_alive:
        return colors, ys
    return colors


def _silhouette_factor(scene, o, d, t_sel, j, alive):
    """Boundary (silhouette) gradients via a value-preserving ratio.

    The pathwise estimator's radiance is constant w.r.t. WHICH primitive a
    ray hits — geometry only moves the discontinuity boundary, so image
    gradients w.r.t. primitive positions are zero a.e. and large position
    offsets never recover. Both primitive classes
    have analytic silhouettes, so the boundary term has a cheap surrogate:
    treat each ray×primitive visibility event as a Bernoulli with a *soft*
    probability.

    Spheres (circle silhouette, from the ray-line/center separation):

        cov_s  = sigmoid((|r_s| - dmin_s) / w_s)          (hit event)
        p_s    = cov_s   if the ray's winner is sphere s
                 1-cov_s otherwise (sphere s in front failed to occlude)

    Quads (four [0,1) planar-coordinate edges, quad.rs:33-54): evaluate
    the ray's hit point on the quad's plane, take its planar coords
    (alpha, beta) via the same w = n/(n.n) construction as the hard test
    (quad.rs:20-29), and soften each edge with a sigmoid:

        cov_q = sig(a/w)sig((1-a)/w)sig(b/w)sig((1-b)/w),  w = 0.05
        p_q   = cov_q    if the winner is quad q
                1-g*cov_q otherwise (g = hard "plane crossing in front"
                                     gate, detached)

    and multiply throughput by prod p / stop_grad(prod p): forward value
    is exactly 1 (the estimator is unchanged, unbiased), while the
    backward pass sees the score-function term d log p / d(params). Summed
    over rays straddling a silhouette this approximates the edge integral
    (f_in - f_out) dEdge/dparam — the practical stand-in for explicit edge
    sampling (SURVEY.md §7 "edge-aware estimator"), same construction as
    the NEE soft-shadow surrogate below.

    Rays and the winner t are detached: the factor differentiates scene
    geometry only. Primitives strictly behind the winner surface get p = 1
    (moving them cannot change this ray — no spurious gradient).
    """
    sg = jax.lax.stop_gradient
    o = sg(o)
    d = sg(d)
    t_sel = sg(t_sel)
    ns = scene.sph_center.shape[0]
    # (Ns, R) orientation throughout: R is the minor axis, so every
    # materialized intermediate is dense even when Ns is small.
    cx = scene.sph_center[:, 0:1]                          # (Ns,1) attached
    cy = scene.sph_center[:, 1:2]
    cz = scene.sph_center[:, 2:3]
    r = jnp.abs(scene.sph_radius)[:, None]                 # (Ns,1)

    hit = t_sel < isect.MISS_T
    t_lim = jnp.where(hit, t_sel, 3.0e30)[None, :]         # (1,R)
    is_sph_winner = (
        hit[None, :] & (j[None, :] == jnp.arange(ns)[:, None])
    )                                                      # (Ns,R)

    ox, oy, oz = o[:, 0][None, :], o[:, 1][None, :], o[:, 2][None, :]
    dx, dy, dz = d[:, 0][None, :], d[:, 1][None, :], d[:, 2][None, :]
    cox = cx - ox                                          # (Ns,R)
    coy = cy - oy
    coz = cz - oz
    s_along = cox * dx + coy * dy + coz * dz               # (Ns,R)
    # Hit event: closest approach of the forward ray line (no far clamp —
    # the winner IS this sphere, its own hit t would clamp onto the surface
    # and flatten cov to 1/2 for every interior ray). Pass-by event: clamp
    # to the winner t so spheres behind the actual hit stay inert.
    s_hit = jnp.maximum(s_along, float(isect.T_MIN))
    s_blk = jnp.clip(s_along, float(isect.T_MIN), t_lim)
    s_eff = jnp.where(is_sph_winner, s_hit, s_blk)
    ex = ox + s_eff * dx - cx
    ey = oy + s_eff * dy - cy
    ez = oz + s_eff * dz - cz
    dmin = jnp.sqrt(jnp.maximum(ex * ex + ey * ey + ez * ez, 1e-12))
    w = 0.05 * r + 1e-5
    cov = jax.nn.sigmoid((r - dmin) / w)
    p = jnp.where(is_sph_winner, cov, 1.0 - cov)
    p = jnp.where(scene.sph_valid[:, None] & alive[None, :], p, 1.0)
    # Clamp p BEFORE forming the ratio so numerator and denominator always
    # match: the forward value is exactly 1 and only the gradient flows.
    # Clamping just the denominator would darken the forward render
    # whenever p < 1e-3 (e.g. a segment originating deep inside a sphere).
    p = jnp.maximum(p, 1e-3)
    ratio = jnp.prod(p / sg(p), axis=0)                    # (R,)

    # ---- quad edges (same (Nq, R) dense-lane orientation) ----
    nq = scene.quad_corner.shape[0]
    qn = jnp.cross(scene.quad_u, scene.quad_v)             # (Nq,3) attached
    qd = jnp.sum(qn * scene.quad_corner, axis=-1)          # (Nq,)
    qw = qn / jnp.maximum(
        jnp.sum(qn * qn, axis=-1, keepdims=True), 1e-12)   # (Nq,3)
    nx_, ny_, nz_ = qn[:, 0:1], qn[:, 1:2], qn[:, 2:3]     # (Nq,1)
    denom = nx_ * dx + ny_ * dy + nz_ * dz                 # (Nq,R)
    # parallel rays never cross the plane: keep t finite, gate them off
    denom_ok = jnp.abs(denom) > 1e-8
    denom_safe = jnp.where(denom_ok, denom, 1.0)
    n_dot_o = nx_ * ox + ny_ * oy + nz_ * oz
    t_pl = (qd[:, None] - n_dot_o) / denom_safe            # (Nq,R)
    prx = ox + t_pl * dx - scene.quad_corner[:, 0:1]       # (Nq,R)
    pry = oy + t_pl * dy - scene.quad_corner[:, 1:2]
    prz = oz + t_pl * dz - scene.quad_corner[:, 2:3]
    ux_, uy_, uz_ = (scene.quad_u[:, 0:1], scene.quad_u[:, 1:2],
                     scene.quad_u[:, 2:3])
    vx_, vy_, vz_ = (scene.quad_v[:, 0:1], scene.quad_v[:, 1:2],
                     scene.quad_v[:, 2:3])
    wx_, wy_, wz_ = qw[:, 0:1], qw[:, 1:2], qw[:, 2:3]
    # alpha = (pr x v) . w ; beta = (u x pr) . w   (quad.rs:33-54)
    alpha = ((pry * vz_ - prz * vy_) * wx_
             + (prz * vx_ - prx * vz_) * wy_
             + (prx * vy_ - pry * vx_) * wz_)
    beta = ((uy_ * prz - uz_ * pry) * wx_
            + (uz_ * prx - ux_ * prz) * wy_
            + (ux_ * pry - uy_ * prx) * wz_)
    wq = 0.05                                   # 5% of each edge length
    cov_q = (jax.nn.sigmoid(alpha / wq) * jax.nn.sigmoid((1.0 - alpha) / wq)
             * jax.nn.sigmoid(beta / wq) * jax.nn.sigmoid((1.0 - beta) / wq))
    is_quad_winner = (
        hit[None, :] & ((j[None, :] - ns) == jnp.arange(nq)[:, None])
    )
    # pass-by: only a plane crossing strictly in front of the winner can
    # be a failed occlusion (detached hard gate, like the sphere clamp)
    gate = (
        denom_ok & (sg(t_pl) > float(isect.T_MIN)) & (sg(t_pl) < t_lim)
    ).astype(jnp.float32)
    pq = jnp.where(is_quad_winner, cov_q, 1.0 - gate * cov_q)
    pq = jnp.where(scene.quad_valid[:, None] & alive[None, :], pq, 1.0)
    pq = jnp.maximum(pq, 1e-3)
    return ratio * jnp.prod(pq / sg(pq), axis=0)           # (R,)


def _nee_contribution(
    scene, rec, hit_live, throughput, d, seed, pixel_id, sample_id, bounce,
    select,
):
    """Direct-light term via area sampling of quad lights.

    One light is chosen uniformly among the scene's quad lights per shading
    point; the estimator is weighted by the light count. The shadow test is
    detached (discrete visibility) and needs only a screening t, so it uses
    the cheap `select` pass (no HitRecord assembly, no recompute) and is
    saved as a remat residual like the winner selection.
    """
    from tinyraytracer_tpu.models import materials as mat
    from tinyraytracer_tpu.ops import rng

    # quad lights (static shapes; mask selects at runtime)
    light_mask = (
        jnp.take(scene.mat_kind, scene.quad_mat) == mat.LIGHT
    ) & scene.quad_valid                                  # (Nq,)
    n_lights = jnp.sum(light_mask.astype(jnp.int32))
    any_light = n_lights > 0

    u1, u2, u3, _ = rng.uniform4(
        seed, pixel_id, sample_id, jnp.uint32(0x40000000) + bounce
    )
    # pick the k-th light, k = floor(u3 * NL): index of the k-th True
    k = jnp.clip(
        (u3 * n_lights.astype(jnp.float32)).astype(jnp.int32), 0,
        jnp.maximum(n_lights - 1, 0),
    )                                                      # (R,)
    cum = jnp.cumsum(light_mask.astype(jnp.int32)) - 1     # (Nq,) 0-based
    # il[r] = first quad index whose cumulative count equals k[r]; the
    # (Nq, R) orientation keeps R the compare matrix's minor axis, and the
    # discrete choice is saved as a remat residual like the selections.
    eq = (cum[:, None] == k[None, :]) & light_mask[:, None]
    il = checkpoint_name(jnp.argmax(eq, axis=0), "select")  # (R,)

    corner = isect.take_rows(scene.quad_corner, il)
    lu = isect.take_rows(scene.quad_u, il)
    lv = isect.take_rows(scene.quad_v, il)
    l_emit = isect.take_rows(scene.mat_emit, jnp.take(scene.quad_mat, il))

    y = corner + u1[:, None] * lu + u2[:, None] * lv       # point on light
    x = rec.point
    to_l = y - x
    r2 = jnp.sum(to_l * to_l, axis=-1)
    dist = jnp.sqrt(jnp.maximum(r2, 1e-12))
    w = to_l / dist[:, None]                               # unit, x -> y
    ln = jnp.cross(lu, lv)
    area = jnp.sqrt(jnp.maximum(jnp.sum(ln * ln, axis=-1), 1e-24))
    ln_unit = ln / area[:, None]
    cos_x = jnp.sum(rec.normal * w, axis=-1)
    cos_y = jnp.abs(jnp.sum(ln_unit * w, axis=-1))         # double-sided light

    # Only diffuse surfaces get NEE (specular transport stays BSDF-sampled).
    active = (
        hit_live & (rec.mat_kind == mat.LAMBERTIAN) & any_light & (cos_x > 0.0)
    )

    # Detached shadow ray x -> y: occluded iff anything lies closer than
    # the light sample (selection-only screen; no record assembly).
    sg = jax.lax.stop_gradient
    occ_t, _ = checkpoint_name(select(sg(x), sg(w)), "select")
    visible = ~(occ_t < sg(dist) * (1.0 - 1e-3))

    # Soft-shadow surrogate gradient for SPHERE occluders: the hard
    # visibility above is detached, which silences the strongest positional
    # cue — the sphere's shadow. For each sphere, an analytic soft
    # visibility from the segment-to-center distance is attached as a
    # value-preserving ratio V_soft / stop_grad(V_soft) (forward value is
    # exactly the hard V; backward sees d(log V_soft)/d(center, radius)).
    # This is the practical stand-in for true silhouette edge sampling
    # (SURVEY.md §7 "edge-aware estimator").
    # (Ns, R) orientation: R minor (see _silhouette_factor).
    scx = scene.sph_center[:, 0:1]                          # (Ns,1)
    scy = scene.sph_center[:, 1:2]
    scz = scene.sph_center[:, 2:3]
    r_all = jnp.abs(scene.sph_radius)[:, None]              # (Ns,1)
    xx, xy_, xz = x[:, 0][None, :], x[:, 1][None, :], x[:, 2][None, :]
    wx, wy, wz = w[:, 0][None, :], w[:, 1][None, :], w[:, 2][None, :]
    cxx = scx - xx                                          # (Ns,R)
    cxy = scy - xy_
    cxz = scz - xz
    s_along = cxx * wx + cxy * wy + cxz * wz                # (Ns,R)
    s_clamp = jnp.clip(s_along, 0.0, dist[None, :])
    ex = xx + s_clamp * wx - scx
    ey = xy_ + s_clamp * wy - scy
    ez = xz + s_clamp * wz - scz
    dsep = jnp.sqrt(jnp.maximum(ex * ex + ey * ey + ez * ez, 1e-12))
    soft_w = 0.25 * r_all + 1e-6
    v_soft_i = jax.nn.sigmoid((dsep - r_all) / soft_w)
    v_soft_i = jnp.where(scene.sph_valid[:, None], v_soft_i, 1.0)
    v_soft = jnp.prod(v_soft_i, axis=0)                     # (R,)

    # QUAD occluders get the same treatment: soft coverage of the shadow
    # segment's plane crossing, softened on the four [0,1) planar-coord
    # edges (the quad analog of the circle separation above — see
    # _silhouette_factor for the construction). The crossing-in-range
    # gate is hard and detached; the sampled light's own plane sits at
    # s = dist and is excluded by the (1 - 1e-3) slack, matching the
    # hard visibility test.
    qn_s = jnp.cross(scene.quad_u, scene.quad_v)            # (Nq,3)
    qd_s = jnp.sum(qn_s * scene.quad_corner, axis=-1)       # (Nq,)
    qw_s = qn_s / jnp.maximum(
        jnp.sum(qn_s * qn_s, axis=-1, keepdims=True), 1e-12)
    nqx, nqy, nqz = qn_s[:, 0:1], qn_s[:, 1:2], qn_s[:, 2:3]
    den_s = nqx * wx + nqy * wy + nqz * wz                  # (Nq,R)
    den_ok = jnp.abs(den_s) > 1e-8
    den_safe = jnp.where(den_ok, den_s, 1.0)
    s_pl = (qd_s[:, None] - (nqx * xx + nqy * xy_ + nqz * xz)) / den_safe
    prx = xx + s_pl * wx - scene.quad_corner[:, 0:1]
    pry = xy_ + s_pl * wy - scene.quad_corner[:, 1:2]
    prz = xz + s_pl * wz - scene.quad_corner[:, 2:3]
    qux, quy, quz = (scene.quad_u[:, 0:1], scene.quad_u[:, 1:2],
                     scene.quad_u[:, 2:3])
    qvx, qvy, qvz = (scene.quad_v[:, 0:1], scene.quad_v[:, 1:2],
                     scene.quad_v[:, 2:3])
    qwx, qwy, qwz = qw_s[:, 0:1], qw_s[:, 1:2], qw_s[:, 2:3]
    al_s = ((pry * qvz - prz * qvy) * qwx
            + (prz * qvx - prx * qvz) * qwy
            + (prx * qvy - pry * qvx) * qwz)
    be_s = ((quy * prz - quz * pry) * qwx
            + (quz * prx - qux * prz) * qwy
            + (qux * pry - quy * prx) * qwz)
    wq_s = 0.05
    cov_qs = (jax.nn.sigmoid(al_s / wq_s)
              * jax.nn.sigmoid((1.0 - al_s) / wq_s)
              * jax.nn.sigmoid(be_s / wq_s)
              * jax.nn.sigmoid((1.0 - be_s) / wq_s))
    gate_s = (
        den_ok & (sg(s_pl) > 1e-3)
        & (sg(s_pl) < dist[None, :] * (1.0 - 1e-3))
    ).astype(jnp.float32)
    v_soft_q = 1.0 - gate_s * cov_qs
    v_soft_q = jnp.where(scene.quad_valid[:, None], v_soft_q, 1.0)
    v_soft_q = jnp.maximum(v_soft_q, 1e-3)
    v_soft = v_soft * jnp.prod(v_soft_q, axis=0)
    v_ratio = v_soft / jnp.maximum(sg(v_soft), 1e-3)

    # f/pdf = (albedo/pi) * E * cos_x * |cos_y| * A * NL / r^2. The 1/r^2
    # term is unbounded for shading points adjacent to the light plane
    # (fireflies + exploding gradients); clamp it — the standard biased
    # stabilization, only active in the near-light sliver.
    geom = cos_x * cos_y * area * n_lights.astype(jnp.float32) / jnp.maximum(
        r2, 1e-12
    )
    geom = jnp.minimum(geom, 16.0 * jnp.pi)
    contrib = (
        throughput
        * rec.albedo
        * l_emit
        * (geom * v_ratio / jnp.pi)[:, None]
    )
    gate = (active & visible)[:, None]
    return jnp.where(gate, contrib, 0.0)


def render_pixels(
    scene: SceneArrays,
    camera: Camera,
    pixel_id,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed,
    exact: bool = False,
    spp_offset=0,
    bvh=None,
    nee: bool = False,
    silhouette: bool = False,
    fuse_spp: bool = False,
) -> jax.Array:
    """Mean radiance over `spp` jittered samples for the given flat pixel ids.

    This is the fusion of the reference's three pipeline stages
    (pointgen -> sampler -> imager, renderer/renderer.rs:62-78) into one
    compiled program: generation, tracing and accumulation are one program.
    `pixel_id` may be any subset/shard of the image — the sharding unit.
    """
    background = jnp.asarray(background, jnp.float32)
    seed = jnp.uint32(seed)
    npix = pixel_id.shape[0]

    # Wavefront width: trace `chunk` samples of every pixel in ONE wavefront
    # (R = chunk*npix rays) so the device sees long vectors instead of spp
    # sequential rounds — the backward pass in particular is dominated by
    # per-round latency at small R. chunk divides spp; its size is capped so
    # peak memory stays at one ~1M-ray wavefront (SURVEY.md §5 streaming).
    if fuse_spp:
        cap = max(1, _FUSE_RAY_TARGET // max(npix, 1))
        chunk = 1
        for c in range(min(spp, cap), 0, -1):
            if spp % c == 0:
                chunk = c
                break
    else:
        chunk = 1
    rounds = spp // chunk

    def round_body(acc, s0):
        # s0 = first global sample id of this round (round covers
        # [s0, s0 + chunk)).
        if chunk == 1:
            pid, sid = pixel_id, s0
        else:
            pid = jnp.tile(pixel_id, chunk)
            sid = jnp.repeat(
                s0 + jnp.arange(chunk, dtype=jnp.uint32), npix
            )
        o, d = generate_rays(camera, pid, sid, seed)
        c = trace(
            scene, o, d, pid, sid, seed, max_bounces, background,
            exact=exact, bvh=bvh, nee=nee, silhouette=silhouette,
        )
        if chunk > 1:
            c = c.reshape(chunk, npix, 3).sum(axis=0)
        return acc + c, None

    starts = (
        jnp.arange(rounds, dtype=jnp.uint32) * jnp.uint32(chunk)
        + jnp.uint32(spp_offset)
    )
    acc, _ = jax.lax.scan(
        round_body, jnp.zeros((npix, 3), jnp.float32), starts
    )
    return acc / jnp.float32(spp)


@partial(
    jax.jit,
    static_argnames=("spp", "max_bounces", "exact", "nee", "silhouette"),
)
def render_image(
    scene: SceneArrays,
    camera: Camera,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed=0,
    exact: bool = False,
    bvh=None,
    nee: bool = False,
    silhouette: bool = False,
) -> jax.Array:
    """Render the full image. Returns (height, width, 3) linear radiance."""
    w, h = camera.width, camera.height
    pixel_id = jnp.arange(w * h, dtype=jnp.uint32)
    img = render_pixels(
        scene,
        camera,
        pixel_id,
        spp=spp,
        max_bounces=max_bounces,
        background=background,
        seed=seed,
        exact=exact,
        bvh=bvh,
        nee=nee,
        silhouette=silhouette,
    )
    return img.reshape(h, w, 3)


def mean_executed_bounces(scene, camera, *, max_bounces: int, background,
                          spp: int = 2, seed: int = 0) -> float:
    """Empirical mean bounce segments per camera ray for this scene.

    Traces a low-spp wavefront (count_alive=True) and integrates the
    survival curve: executed segments = 1 (the guaranteed first bounce) +
    sum_b alive_after(b). The path-length distribution is camera/scene
    geometry, independent of resolution to first order and of the device,
    so a cheap low-spp estimate serves any render size of the same scene.
    """
    npix = camera.width * camera.height
    alive_total = 0.0
    for s in range(spp):
        pid = jnp.arange(npix, dtype=jnp.uint32)
        o, d = generate_rays(camera, pid, jnp.uint32(s), jnp.uint32(seed))
        _, alive_counts = trace(
            scene, o, d, pid, jnp.uint32(s), jnp.uint32(seed),
            max_bounces=max_bounces, background=jnp.asarray(background),
            count_alive=True,
        )
        # alive_after(max_bounces-1) rays execute no further segment.
        alive_total += float(jnp.sum(alive_counts[:-1]))
    return 1.0 + alive_total / (npix * spp)
