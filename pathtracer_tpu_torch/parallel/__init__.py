"""Multi-device rendering over ``torch.distributed`` (``parallel/``): a
(rays, spp) grid of device slots, the sharded renderer, and process-group
bring-up."""
from pathtracer_tpu_torch.parallel.mesh import (RAYS_AXIS, SPP_AXIS, Mesh,
                                                initialize_distributed,
                                                make_mesh)
from pathtracer_tpu_torch.parallel.sharded import (make_sharded_renderer,
                                                   sharded_render_image)

__all__ = [
    "RAYS_AXIS", "SPP_AXIS", "Mesh", "make_mesh", "initialize_distributed",
    "make_sharded_renderer", "sharded_render_image",
]
