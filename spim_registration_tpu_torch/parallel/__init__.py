"""The multi-device layer: device mesh, halo exchange, sharded kernels,
and processes joined into one mesh.

Port of the reference's `parallel/` package (a `jax.sharding.Mesh` driven
by `shard_map`, with `ppermute` halos and `psum` reductions): here a
`Mesh` is a grid of `torch.device`s, and the cross-shard steps are the
functions of `parallel/mesh.py`. The reference's multi-controller part
(`parallel/multihost.py`, `jax.distributed`) is `torch.distributed`
here: after `initialize_multihost` a mesh spans the processes and the
same functions reach across them.
"""

from spim_registration_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange_z,
)
from spim_registration_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_from_spec,
)
from spim_registration_tpu_torch.parallel.multihost import (  # noqa: F401
    host_z_mesh,
    initialize_multihost,
    shard_timepoints,
)
from spim_registration_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_deconvolution_runner,
    sharded_deconvolve,
    sharded_dog,
    sharded_fft_convolve,
    sharded_fuse_views,
    sharded_gaussian_blur,
)
from spim_registration_tpu_torch.parallel.sharded_detect import (  # noqa: F401
    sharded_detect_beads,
    sharded_detect_beads_dom,
)
