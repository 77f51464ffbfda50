"""Reconstruction: occupancy grids of decoded fields and host meshing, and
surface points of unsigned distance fields."""
from .extractor import MeshExtractor, MeshExtractorConfig
from .grid import (
    dense_grid_values,
    grid_coordinates,
    hierarchical_grid_values,
)
from .mesh import Mesh
from .udf import UDFDraws, UDFExtractorConfig, extract_surface_points

__all__ = [
    "Mesh",
    "dense_grid_values",
    "hierarchical_grid_values",
    "grid_coordinates",
    "MeshExtractor",
    "MeshExtractorConfig",
    "UDFDraws",
    "UDFExtractorConfig",
    "extract_surface_points",
]
