"""dask_sql_tpu_torch: the SQL engine of `dask_sql_tpu`, ported to PyTorch
and CUDA.  It imports neither JAX nor `dask_sql_tpu`; its entry points run on
the CUDA card unless the caller asks for the CPU (`Context(device="cpu")`)."""
from .context import Context

__all__ = ["Context"]
