"""Command-line entry points of the port (``train``, ``serve``, the
production dry run ``dryrun``) and the meshes the dry run lays its
cells on."""

from .mesh import MeshSpec, make_production_mesh

__all__ = ["MeshSpec", "make_production_mesh"]
