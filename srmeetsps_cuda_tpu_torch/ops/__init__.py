"""Dense-grid operators: resampling, gradients, normals."""
