"""HDF5 input and output: file checks, RTM, images, Laplacian, voxel map, solution."""
