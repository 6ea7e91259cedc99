"""Retrieval, top-k and seen-filter ops (torch port, with Hopper kernels)."""
