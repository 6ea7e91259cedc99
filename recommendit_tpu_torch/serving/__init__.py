"""Serving pipeline (torch port)."""
