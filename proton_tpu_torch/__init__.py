"""PyTorch / CUDA port of proton_tpu for the NVIDIA H100 (JAX
counterpart: the ``proton_tpu`` package beside it).

It holds the cutHHO fictitious-domain solve on the generated mesh
(``cut.fictdom_structured.solve_fictdom_structured``: the lean system with
the multigrid V-cycle by default, kernel K1 for the fitted operators) and
the uncut HHO path on quad and polygonal meshes (``methods.poisson``,
``methods.condensation``, ``methods.obstacle`` and the ``apps``).

The package namespace re-exports the mesh constructors, the boundary
codes, the cell geometry, ``HHODegreeInfo`` and the modules ``hho``,
``assembly`` and ``cg``, as ``proton_tpu`` does. Importing it builds no
kernel: K1 is compiled on its first launch.
"""

from . import config  # noqa: F401  (switches TF32 off on import; first)
from .core.mesh import (Mesh, MeshInitParams, make_quad_mesh,  # noqa: F401
                        make_poly_mesh, load_poly_mesh, BND_DIRICHLET,
                        BND_NEUMANN, BND_NONE, BND_ROBIN)
from .core.geometry import cell_geometry, CellGeom  # noqa: F401
from .core.ops import HHODegreeInfo  # noqa: F401
from .methods import hho, assembly  # noqa: F401
from .solvers import cg  # noqa: F401

__version__ = "0.1.0"
