from repro_torch.kernels.stencil_assembly.stencil_assembly import (  # noqa: F401
    face_arrays, momentum_bands, momentum_bands_cost, momentum_bands_plain,
    momentum_bands_stacked)
