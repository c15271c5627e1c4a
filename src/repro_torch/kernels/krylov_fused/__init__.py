from repro_torch.kernels.krylov_fused.krylov_fused import (  # noqa: F401
    fused_axpy_precond_cost, fused_axpy_precond_plain, fused_matvec_dot,
    fused_update_step, spmv_dot_cost, spmv_dot_plain)
