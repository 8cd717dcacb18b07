"""Host I/O: image-array loading and the point-cloud export (copies of the
JAX package's ``io`` modules)."""
