"""tinyraytracer_tpu — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
``cheolwanpark/tiny-raytracer`` (Rust + Metal): thin-lens camera, sphere/quad
geometry with composite groups, Lambertian/metal/dielectric/light materials,
unidirectional path tracing with emission + background, BVH acceleration,
gamma-2.2 PNG output — rebuilt as SoA scene pytrees, a masked wavefront
bounce loop under ``lax.scan``/``lax.while_loop``, a fused GPU path-tracing
kernel (Pallas lowered through Triton), counter-based (hash) RNG, batched
intersection, and mesh sharding via ``shard_map`` instead of worker
threads. Fully differentiable: gradients flow from pixels to sphere
centers/radii, quad vectors, and material albedo/fuzz/IOR.

Reference capability map (file:line cites are relative to the reference repo):
  - camera.rs:16-71        -> models.camera
  - hittable/*             -> models.geometry, ops.intersect, ops.bvh
  - material/*             -> models.materials, ops.scatter
  - renderer/*             -> renderer.Renderer, ops.trace
  - utils/image.rs         -> utils.image, ops.tonemap
  - utils/random.rs        -> ops.rng (counter-based, seedable, deterministic)
  - sampler/metal/*        -> ops.megakernel (fused GPU sampler), ops.bvh
"""

from tinyraytracer_tpu.models.camera import Camera
from tinyraytracer_tpu.models.geometry import Sphere, Quad, Group, make_box
from tinyraytracer_tpu.models.materials import (
    Lambertian,
    Metal,
    Dielectric,
    Light,
)
from tinyraytracer_tpu.models.ray import Ray
from tinyraytracer_tpu.models.transform import Transform
from tinyraytracer_tpu.models.world import World, SceneArrays
from tinyraytracer_tpu.renderer import Renderer, RenderHandle
from tinyraytracer_tpu.utils.image import Image

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Sphere",
    "Quad",
    "Group",
    "make_box",
    "Lambertian",
    "Metal",
    "Dielectric",
    "Light",
    "Ray",
    "Transform",
    "World",
    "SceneArrays",
    "Renderer",
    "RenderHandle",
    "Image",
]
