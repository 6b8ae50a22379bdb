from . import mesh, spmd  # noqa: F401
