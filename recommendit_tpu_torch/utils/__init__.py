"""Framework-free helpers of the port (copies of the JAX package's where
they exist there) and its device rule."""
