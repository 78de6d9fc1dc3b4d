from tpu_collide_torch.index.grid import (GridIndex, build_grid, query_radius,
                                         gather_candidates, cell_coords)
