"""cudapathtracer_tpu — a wavefront physically-based renderer in JAX/XLA.

A brand-new wavefront re-design of the CUDA reference renderer "Novum"
(DanielQ-51/cudapathtracer): five global-illumination integrators (naive PT,
unidirectional PT with NEE+MIS, BDPT, SPPM, VCM) over triangle meshes with a
SAH BVH, a BSDF library, thin-lens/pinhole cameras, textures and a BMP/CSV
image pipeline.

Architecture (wavefront, not a port):
  - wavefront SoA ray batches instead of one-thread-per-pixel megakernels
  - stackless multi-octant threaded BVH traversal (hit/miss links) instead of
    per-thread traversal stacks (reference: integratorUtilities.cuh:84-186)
  - counter-based Threefry RNG keyed on (sample, bounce, draw) + array lane
    instead of per-thread curand XORWOW state (reference: deviceCode.cu:53-61)
  - scatter-add / sort-compaction instead of device atomics
  - jax.jit sample steps instead of CUDA Graphs (reference: deviceCode.cu:1857)
  - shard_map image-tile sharding + psum collectives for multi-device
    scaling
"""

__version__ = "0.1.0"

from cudapathtracer_tpu.utils.config import RenderConfig, load_config  # noqa: F401
