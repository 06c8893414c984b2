from .mesh import (Mesh, unit_square_mesh, unit_cube_mesh,
                   tagged_unit_square, tagged_unit_cube,
                   submesh_from_cells, submesh_where_marker,
                   mesh_from_facets, embed_vertices,
                   near, pred_and, pred_or, le, ge)
from .assembly import (stiffness_matrix, mass_matrix, load_vector,
                       facet_load_vector, DirichletBC,
                       apply_bc_monolithic, interpolate)
from .error import errornorm_p1
from . import mms
