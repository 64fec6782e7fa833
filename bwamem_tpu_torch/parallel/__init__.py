from bwamem_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, replicated, rowmap)
