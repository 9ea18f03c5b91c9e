"""Host-side utilities (copies of the JAX package's)."""

from .streams import EventStream

__all__ = ["EventStream"]
