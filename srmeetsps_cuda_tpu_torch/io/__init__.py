"""Dataset loaders and result writers (numpy, scipy; h5py and Pillow are
imported only by the MAT 7.3 and PNG paths)."""
