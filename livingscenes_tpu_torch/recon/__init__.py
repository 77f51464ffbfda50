"""Reconstruction: occupancy grids of decoded fields and host meshing."""
from .extractor import MeshExtractor, MeshExtractorConfig
from .grid import (
    dense_grid_values,
    grid_coordinates,
    hierarchical_grid_values,
)
from .mesh import Mesh

__all__ = [
    "Mesh",
    "dense_grid_values",
    "hierarchical_grid_values",
    "grid_coordinates",
    "MeshExtractor",
    "MeshExtractorConfig",
]
