from .mesh import default_mesh
from .triples_shard import triples_energy_sharded

__all__ = ["default_mesh", "triples_energy_sharded"]
