from repro_torch.kernels.coef_update.coef_update import (  # noqa: F401
    coef_update, coef_update_cost, coef_update_plain, coef_update_stacked)
