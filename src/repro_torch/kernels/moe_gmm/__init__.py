from repro_torch.kernels.moe_gmm.kernel import gmm_tiles_cuda
from repro_torch.kernels.moe_gmm.ops import GroupedRows, gmm, tile_layout
from repro_torch.kernels.moe_gmm.ref import expert_of_rows, gmm_reference

__all__ = ["GroupedRows", "gmm", "gmm_reference", "gmm_tiles_cuda", "expert_of_rows",
           "tile_layout"]
