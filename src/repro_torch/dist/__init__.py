"""Distribution substrate of the port. So far only the logical-axis rule
tables and the mesh context (`sharding`); the compressed collectives and the
pipeline wait for ROADMAP Queue 1's `dist/` item."""
from . import sharding  # noqa: F401
