from repro_torch.kernels.spmv_dia.spmv_dia import (  # noqa: F401
    spmv_dia_cost, spmv_dia_plain, spmv_dia_stacked)
