"""Multi-rank parallelism for the port: process groups and device meshes
(``mesh.py``), the differentiable collectives of a sharded model
(``collectives.py``), GPipe pipelining (``pipeline.py``), data parallelism
with ZeRO-1 (``zero.py``).  Port of ``protstruc_tpu/parallel``; the collectives
the JAX package leaves to GSPMD are written out with ``torch.distributed``.
"""

from protstruc_tpu_torch.parallel.mesh import (
    batch_pspecs,
    featurize_sharded,
    init_distributed,
    make_mesh,
    make_multislice_mesh,
    shard_batch,
)
