from .thomas import thomas, thomas_scan, thomas_along_axis, cyclic_thomas
from .spectral import phi_solve_spectral
