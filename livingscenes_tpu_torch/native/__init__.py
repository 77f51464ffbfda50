"""The port's host geometry: isosurface extraction, quadric simplification,
kd-tree queries, point-in-mesh tests and voxelization in C++ (src/), built
with g++ at first use and bound with ctypes."""
