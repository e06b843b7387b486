"""Parallelism of the port: device meshes (`mesh`, a port of
`mxnet_tpu/parallel/mesh.py`, which the sub-mesh serving replicas run
over) and the fused `SPMDTrainer`, on one device so far (a port of
`mxnet_tpu/parallel/trainer.py`)."""
from .mesh import (Mesh, MeshContext, get_mesh, make_mesh,
                   data_parallel_sharding, mesh_signature, submeshes)
from .trainer import SPMDTrainer, load_params

__all__ = ["Mesh", "MeshContext", "get_mesh", "make_mesh",
           "data_parallel_sharding", "mesh_signature", "submeshes",
           "SPMDTrainer", "load_params"]
