"""Data of the torch port: MovieLens-format arrays and the synthetic generator."""
