"""Host-side data path (numpy): meshes, synthetic simulations, scaling and the
padded temporal samples."""
