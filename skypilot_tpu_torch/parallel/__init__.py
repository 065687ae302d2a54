"""Meshes, sharding rules and collectives of the port: one process a
rank under ``torch.distributed`` (parallel/mesh.py), where the JAX
package builds one ``jax.sharding.Mesh`` under a single controller."""
from skypilot_tpu_torch.parallel.mesh import (AXES, Mesh, MeshConfig,
                                              auto_mesh_config, make_mesh,
                                              make_multislice_mesh)
from skypilot_tpu_torch.parallel.sharding import PartitionRules, shard_tensor

__all__ = ['AXES', 'Mesh', 'MeshConfig', 'make_mesh', 'make_multislice_mesh',
           'auto_mesh_config', 'PartitionRules', 'shard_tensor']
