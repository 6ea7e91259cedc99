"""Logging setup of the port's command-line entry points (a copy of the JAX
package's ``utils/logging.py``)."""
import logging


def setup_logging(level: str = "INFO") -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
    )
