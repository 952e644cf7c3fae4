"""adi_thermal_fields_tpu — transient 3-D heat conduction for WAAM in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
``Matemusi/ADI_thermal_fields``: ADI time stepping with batched tridiagonal
solves on Cartesian masked-voxel and cylindrical (r, phi, z) grids, unified
Dirichlet/Neumann/Robin boundary conditions, element birth, STL geometry with
voxel boundary-area correction, analytic validation oracles, and VTK/GIF
output — redesigned for accelerators (fixed shapes, functional updates,
batched Thomas solves: lax.scan or one Pallas-Triton kernel on NVIDIA GPUs,
jax.sharding domain decomposition).
"""

from .core.grid import CartesianGrid, CylindricalGrid
from .core.material import Material
from .core.timestep import TimeControls
from .bc.faces import FACES, exposed_face, exposed_faces
from .bc.packs import CoeffPacks, build_coeff_packs
from .step.cartesian import adi_step as adi_step_cartesian
from .step.cartesian import apply_surface_impulse
from .step.cylindrical import RobinBC, ZFaceBC
from .step.cylindrical import adi_step as adi_step_cylindrical
from .step.cylindrical import adi_step_masked as adi_step_cylindrical_masked
from .step.cylindrical_masked import adi_step_masked_robin
from .step.cartesian_varprop import (PropertyTable, adi_step_varprop,
                                     apparent_cp)
from .step.cylindrical_varprop import (adi_step_cyl_varprop,
                                       adi_step_cyl_varprop_masked)
from .bc.radiation import STEFAN_BOLTZMANN, radiative_h

__version__ = "0.2.0"

__all__ = [
    "CartesianGrid", "CylindricalGrid", "Material", "TimeControls",
    "FACES", "exposed_face", "exposed_faces",
    "CoeffPacks", "build_coeff_packs",
    "adi_step_cartesian", "apply_surface_impulse",
    "RobinBC", "ZFaceBC", "adi_step_cylindrical", "adi_step_cylindrical_masked",
    "adi_step_masked_robin",
    "PropertyTable", "adi_step_varprop", "apparent_cp",
    "adi_step_cyl_varprop", "adi_step_cyl_varprop_masked",
    "STEFAN_BOLTZMANN", "radiative_h",
]
