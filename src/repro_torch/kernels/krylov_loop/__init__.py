from repro_torch.kernels.krylov_loop.krylov_loop import (  # noqa: F401
    cg_advance, cg_advance_cost, cg_advance_plain, cg_alpha, cg_alpha_cost,
    cg_alpha_plain, cg_direction, cg_direction_cost, cg_direction_plain)
