"""The port's host meshing: isosurface extraction and quadric simplification
in C++ (src/), built with g++ at first use and bound with ctypes."""
