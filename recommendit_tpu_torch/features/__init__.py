"""Feature contract and online store (torch port)."""
