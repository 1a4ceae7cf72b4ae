from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_reference

__all__ = ["ssd_chunked", "ssd_reference", "ssd_scan", "ssd_scan_cuda"]
